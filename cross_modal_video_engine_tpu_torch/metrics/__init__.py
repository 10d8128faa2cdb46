"""Retrieval, accuracy and detection metrics (numpy)."""
from .scorers import getScorer, APScorer, RRScorer, PrecisionScorer, DCGScorer, NDCGScorer
