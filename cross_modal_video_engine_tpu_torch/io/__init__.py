"""Feature stores and checkpoint formats read and written without JAX."""
