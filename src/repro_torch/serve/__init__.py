"""Serving: prefill, decode, and the coded lossy KV transfer."""
