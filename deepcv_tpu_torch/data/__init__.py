"""Data transforms of the port (the serving subset)."""
