"""Train step and host training loop."""
