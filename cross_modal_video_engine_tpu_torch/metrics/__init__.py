"""Retrieval, accuracy and detection metrics (numpy)."""
