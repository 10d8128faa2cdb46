"""Losses of the LINAS dual encoder's, the Combiner's and the caption
recognizer's training."""
from .contrastive import clip_contrastive_loss, info_nce_logits
from .distill import (adaptive_similarity_loss, huber, kl_distill,
                      mse_distill, similarity_distill)
from .triplet import TripletLossConfig, triplet_loss
from .seqmll import multilabel_categorical_crossentropy, seq_mll_loss
