"""Tensor ops of the port (channels-last, JAX package layout)."""
