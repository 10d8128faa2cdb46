"""Retrieval metrics (numpy)."""
