"""Correlation volumes, soft-argmax, resizes and the CUDA warp kernel."""
