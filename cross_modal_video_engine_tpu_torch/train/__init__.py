"""Checkpoints in the JAX package's directory format."""
