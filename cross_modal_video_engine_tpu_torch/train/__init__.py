"""Checkpoints in the JAX package's directory format, resume, the
trainers with their optimizers, and the detector's letterbox."""
