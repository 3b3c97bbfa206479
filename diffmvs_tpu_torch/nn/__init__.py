"""Neural network building blocks (NCHW)."""
