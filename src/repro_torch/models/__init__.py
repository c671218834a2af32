"""Models of the port: the dense decoder family and the paper's toy models."""
