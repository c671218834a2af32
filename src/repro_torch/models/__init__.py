"""Models of the port (dense decoder family)."""
