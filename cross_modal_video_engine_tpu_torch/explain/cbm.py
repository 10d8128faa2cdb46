"""Concept-bottleneck model head.

Counterpart of cross_modal_video_engine_tpu/explain/cbm.py, the
MCT/tools/ctvs/ctv_analysis/concept_bottleneck_model/train_cbm.py:69-94
`Residual_Head`: classify from concept-score logits with a residual
fusion of the raw embedding.  The three `nn.Linear`s carry the names of
the flax `Dense`s (`convert.residual_head_state_dict_from_jax` maps a
JAX head's variables onto them).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ConceptBottleneckConfig:
    embed_dim: int = 768
    n_concepts: int = 64
    num_classes: int = 400
    hidden: int = 256


class ResidualHead(nn.Module):
    def __init__(self, cfg: ConceptBottleneckConfig, device=None):
        super().__init__()
        device = resolve_device(device)   # None: the CUDA device
        self.cfg = cfg
        self.concept_hidden = nn.Linear(cfg.n_concepts, cfg.hidden,
                                        device=device)
        self.concept_fc = nn.Linear(cfg.hidden, cfg.num_classes,
                                    device=device)
        self.embed_fc = nn.Linear(cfg.embed_dim, cfg.num_classes,
                                  device=device)

    def forward(self, embedding: torch.Tensor, concept_scores: torch.Tensor,
                *, train: bool = False):
        """embedding: (B, D); concept_scores: (B, n_concepts).
        Returns (class_logits, concept_branch_logits)."""
        concept_logits = self.concept_fc(F.relu(self.concept_hidden(
            concept_scores)))
        return concept_logits + self.embed_fc(embedding), concept_logits
