"""Mini-batch blending: mixup and cutmix, in PyTorch.

Counterpart of cross_modal_video_engine_tpu/data/blending.py (MCT
mmaction/datasets/blending_utils.py).  Integer labels go in and come out
as (B, num_classes) soft distributions in fp32; the clips keep their
layout (..., H, W, C) and their dtype:

* `mixup`: lam·x + (1 − lam)·x[perm], with lam cast to the clips' dtype;
  the soft labels take the fp32 lam (blending_utils.py:60-88);
* `cutmix`: a box of x[perm] pasted into x, its sides
  int32(side · sqrt(1 − lam)) around a centre (cx, cy), clipped to the
  image; lam is recomputed from the clipped box's area
  (blending_utils.py:91-140).

The JAX package draws lam ~ Beta(alpha, alpha), the permutation and the
centre from a key inside its step.  Here `Blending.draw` makes the same
draws on the host, from a numpy generator the blending owns (`seed`,
`reseed`), and `Blending.__call__` takes them handed in (`draws=`) or
draws them itself, before the step's dropout draws, as the JAX step
splits its key for the blending before the forward.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.registry import Registry

BLENDINGS = Registry("blendings")


@BLENDINGS.register("MixupBlending")
def mixup(imgs: torch.Tensor, one_hot: torch.Tensor,
          draws: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """draws: {"lam", "perm"}."""
    perm = torch.as_tensor(np.array(draws["perm"]), device=imgs.device)
    lam = torch.tensor(np.float32(draws["lam"]), device=imgs.device)
    lam_i = lam.to(imgs.dtype)
    mixed = lam_i * imgs + (1 - lam_i) * imgs[perm]
    soft = lam * one_hot + (1 - lam) * one_hot[perm]
    return mixed, soft


@BLENDINGS.register("CutmixBlending")
def cutmix(imgs: torch.Tensor, one_hot: torch.Tensor,
           draws: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """draws: {"lam", "perm", "cx", "cy"}; imgs (..., H, W, C)."""
    h, w = imgs.shape[-3], imgs.shape[-2]
    dev = imgs.device
    perm = torch.as_tensor(np.array(draws["perm"]), device=dev)
    lam = np.float32(draws["lam"])
    cut_rat = np.sqrt(np.float32(1.0) - lam)
    cut_w = int(np.float32(w) * cut_rat)      # astype(int32): toward 0
    cut_h = int(np.float32(h) * cut_rat)
    cx, cy = int(draws["cx"]), int(draws["cy"])
    bbx1 = min(max(cx - cut_w // 2, 0), w)
    bby1 = min(max(cy - cut_h // 2, 0), h)
    bbx2 = min(max(cx + cut_w // 2, 0), w)
    bby2 = min(max(cy + cut_h // 2, 0), h)
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    box = (ys >= bby1) & (ys < bby2) & (xs >= bbx1) & (xs < bbx2)
    mask = box[..., None].to(imgs.dtype)              # (H, W, 1)
    mixed = imgs * (1 - mask) + imgs[perm] * mask
    lam_adj = np.float32(1.0) - (np.float32((bbx2 - bbx1) * (bby2 - bby1))
                                 / np.float32(h * w))
    lam_t = torch.tensor(lam_adj, device=dev)
    soft = lam_t * one_hot + (1 - lam_t) * one_hot[perm]
    return mixed, soft


class Blending:
    """The `train_cfg=dict(blending=dict(type=..., alpha=...))` callable:
    (imgs, int labels, draws=None) -> (imgs, soft labels)."""

    def __init__(self, name: str, num_classes: int, alpha: float = 0.2,
                 seed: int = 0):
        self.name = name
        self.fn = BLENDINGS.get(name)
        self.num_classes, self.alpha = num_classes, alpha
        self.rng = np.random.default_rng(seed)

    def reseed(self, seed: int) -> None:
        self.rng = np.random.default_rng(seed)

    def draw(self, batch: int, height: int, width: int) -> Dict:
        """One step's draws: lam ~ Beta(alpha, alpha) in fp32, a
        permutation of the batch and, for cutmix, the box's centre."""
        out = {"lam": np.float32(self.rng.beta(self.alpha, self.alpha)),
               "perm": self.rng.permutation(batch)}
        if self.name == "CutmixBlending":
            out["cx"] = int(self.rng.integers(0, width))
            out["cy"] = int(self.rng.integers(0, height))
        return out

    def __call__(self, imgs: torch.Tensor, labels: torch.Tensor,
                 draws: Optional[Dict] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        if draws is None:
            draws = self.draw(imgs.shape[0], imgs.shape[-3], imgs.shape[-2])
        one_hot = F.one_hot(labels.long(), self.num_classes).float()
        return self.fn(imgs, one_hot, draws)


def make_blending(name: str, num_classes: int, alpha: float = 0.2,
                  seed: int = 0) -> Blending:
    """The config key's blending (JAX make_blending)."""
    return Blending(name, num_classes, alpha, seed)
