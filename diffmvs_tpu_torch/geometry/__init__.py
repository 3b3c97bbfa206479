"""Inverse-depth transforms, plane-sweep coordinates, sampling, upsampling."""
