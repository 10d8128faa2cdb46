"""Command-line entry points of the port (retrieval and serving)."""
