"""HTTP service and micro-batcher."""
