"""Encoder orchestration of the port, on top of the JAX package's host tier."""
