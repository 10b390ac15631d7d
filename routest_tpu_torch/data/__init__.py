"""The 12-feature ETA input encoding."""
