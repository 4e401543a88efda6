"""Training step."""
