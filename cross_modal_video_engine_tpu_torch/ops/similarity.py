"""Pairwise similarity measures.

Counterpart of cross_modal_video_engine_tpu/ops/similarity.py: the eight
measures, `get_sim`, and `cal_error` with the evaluation-side branch
semantics.  Every measure takes `im: (n_im, d)` and `s: (n_s, d)` and
returns an (n_im, n_s) matrix, higher = more similar.  Products accumulate
in fp32 (no TF32: the callers' backend setting decides, and the tests run
on the CPU).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..utils.device import resolve_device


def l2norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along `dim`; the eps guard keeps an all-zero row
    (a padded or blank batch entry) at zero instead of NaN."""
    norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp_min(norm, eps)


def cosine_sim(im: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """im @ s.T on already L2-normalized rows, fp32 result."""
    return im.float() @ s.float().t()


def order_sim(im: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """-|max(0, s - im)|_2, as (n_im, n_s)."""
    diff = torch.clamp_min(s[:, None, :] - im[None, :, :], 0.0)
    return -torch.sqrt(torch.sum(diff * diff, dim=2)).t()


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a_i - b_j|^2 by |a|^2 + |b|^2 - 2 a.b, clamped at 0."""
    sq = (torch.sum(a * a, dim=1)[:, None] + torch.sum(b * b, dim=1)[None, :]
          - 2.0 * (a.float() @ b.float().t()))
    return torch.clamp_min(sq, 0.0)


def euclidean_sim(im: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """-(squared L2 distance)."""
    return -_sq_dist(im, s)


def l2_sim(im: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return euclidean_sim(im, s)


def l2_sim_norm(im: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """squared-L2 / dim - 1: a distance-flavoured quantity, the training
    side's exact formula."""
    return _sq_dist(im, s) / im.shape[1] - 1.0


def l1_sim(im: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return -torch.sum(torch.abs(s[:, None, :] - im[None, :, :]), dim=2).t()


def l1_sim_norm(im: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return (torch.sum(torch.abs(s[:, None, :] - im[None, :, :]), dim=2).t()
            / im.shape[1] - 1.0)


def jaccard_sim(im: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """sum(min) / sum(max) over non-negative (tag-probability) vectors."""
    lo = torch.minimum(im[:, None, :], s[None, :, :]).sum(-1)
    hi = torch.maximum(im[:, None, :], s[None, :, :]).sum(-1)
    return lo / hi


SIMILARITIES: Dict[str, Callable] = {
    "cosine": cosine_sim, "order": order_sim, "euclidean": euclidean_sim,
    "l2": l2_sim, "l2_norm": l2_sim_norm, "l1": l1_sim,
    "l1_norm": l1_sim_norm, "jaccard": jaccard_sim,
}


def get_sim(name: str) -> Callable:
    """Training-side similarity by name."""
    try:
        return SIMILARITIES[name]
    except KeyError:
        raise KeyError(f"unknown similarity {name!r}; choose from "
                       f"{sorted(SIMILARITIES)}") from None


def _errors(cap: torch.Tensor, vid: torch.Tensor, measure: str
            ) -> torch.Tensor:
    """The evaluation side's branches, which differ from the training
    formulas above on purpose (each matches its own reference file):
    cosine L2-normalizes internally; euclidean/l1/l2 are positive
    unsquared distances; the *_norm measures are -distance/dim - 1;
    jaccard is -similarity; order is -order_sim in the training
    orientation."""
    d = vid.shape[1]
    if measure == "cosine":
        return -(l2norm(cap) @ l2norm(vid).t())
    if measure in ("euclidean", "l2", "l2_norm"):
        dist = torch.sqrt(_sq_dist(cap, vid))
        return -dist / d - 1.0 if measure == "l2_norm" else dist
    if measure in ("l1", "l1_norm"):
        dist = torch.sum(torch.abs(cap[:, None, :] - vid[None, :, :]), dim=2)
        return -dist / d - 1.0 if measure == "l1_norm" else dist
    if measure == "jaccard":
        return -jaccard_sim(cap, vid)
    if measure == "order":
        return -order_sim(vid, cap).t()
    raise ValueError(f"unknown measure {measure!r}")


def cal_error(videos, captions, measure: str = "cosine", block: int = 0,
              device=None) -> torch.Tensor:
    """Error (lower = better) matrix of shape (n_captions, n_videos) in
    fp32.  `block` > 0 scores the captions in chunks of that many rows, to
    bound the (block, n_videos, d) temporaries of the broadcast measures.
    Both inputs go to one device: that of the first tensor among them,
    else `device` (None: the CUDA device)."""
    tensors = [a for a in (videos, captions) if isinstance(a, torch.Tensor)]
    dev = tensors[0].device if tensors else resolve_device(device)
    vid, cap = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                for a in (videos, captions))
    if block and cap.shape[0] > block:
        return torch.cat([_errors(c, vid, measure)
                          for c in cap.split(block)], 0)
    return _errors(cap, vid, measure)
