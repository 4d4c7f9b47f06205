"""AdamW with a float32 master copy."""
