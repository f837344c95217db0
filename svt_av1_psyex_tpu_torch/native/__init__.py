"""Native (C) backends the port wraps without the JAX package's device tier."""
