"""Checkpoints in the JAX package's directory format, and the LINAS
trainer with its optimizers and resume, and the Combiner's trainer."""
