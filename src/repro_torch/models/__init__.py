"""Models of the port: the paper's 4-layer CNN and the dense decoder."""
