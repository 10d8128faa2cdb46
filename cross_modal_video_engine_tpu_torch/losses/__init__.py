"""Losses of the LINAS dual encoder's training."""
from .distill import (adaptive_similarity_loss, huber, kl_distill,
                      mse_distill, similarity_distill)
from .triplet import TripletLossConfig, triplet_loss
