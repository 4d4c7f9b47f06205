"""Deterministic synthetic token sources (numpy)."""
