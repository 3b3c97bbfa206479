"""Synthetic inputs."""
