"""Teacher->student distillation losses.

Counterpart of cross_modal_video_engine_tpu/losses/distill.py (the
reference LINAS-engine/model.py:553-580 criteria, :834-883 their use):

* `mse_distill`: sum- or mean-reduced squared error between student and
  teacher embeddings.
* `kl_distill`: torch KLDivLoss's target * (log(target) - input), 0 where
  target <= 0; the log's argument is clamped, so that the unselected
  branch leaks no NaN into the gradient.
* `similarity_distill`: SmoothL1 (`huber`) between the two B x B in-batch
  similarity matrices, plain or 'diag' / 'maxdiag' / 'adapt' / 'svd' /
  'eig' (model.py:845-872).  'svd' rebuilds U diag(log s) V with V's
  columns the right singular vectors (V, not V^T: the reference's algebra,
  kept as it is), so it depends on the sign each solver gives a pair of
  singular vectors: the B x B factorization runs on the host (LAPACK, as
  the JAX package's CPU reference does), whatever the device.
  'eig' rebuilds B diag(Re lambda) B^-1 from numpy's float64
  eigendecomposition of a detached host copy: no gradient, as in the JAX
  package (a host callback under stop_gradient) and the reference.
* `adaptive_similarity_loss`: the 'adapt' mask's own objective
  (model.py:835-843, :896-912).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

def huber(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise SmoothL1: 0.5 d^2 if |d| < 1 else |d| - 0.5."""
    d = a - b
    ad = torch.abs(d)
    return torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5)


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    return torch.sum(x) if reduction == "sum" else torch.mean(x)


def mse_distill(student: torch.Tensor, teacher: torch.Tensor,
                reduction: str = "sum") -> torch.Tensor:
    return _reduce((student - teacher) ** 2, reduction)


def kl_distill(student: torch.Tensor, teacher: torch.Tensor,
               reduction: str = "sum") -> torch.Tensor:
    term = torch.where(
        teacher > 0,
        teacher * (torch.log(torch.clamp_min(teacher, 1e-30)) - student),
        torch.zeros((), dtype=teacher.dtype, device=teacher.device))
    return _reduce(term, reduction)


def _svd_log_transform(s: torch.Tensor) -> torch.Tensor:
    """U diag(log sigma) V (model.py:849-853), differentiable.  Computed on
    a host copy inside autograd (the gradient flows back through the
    copy): cuSOLVER gives about half the singular-vector pairs of a
    128 x 128 similarity matrix the other sign than LAPACK (measured on an
    H100 by chip_smoke.py step 11b), which moves this loss by 1%."""
    u, sv, vh = torch.linalg.svd(s.cpu(), full_matrices=False)
    out = (u * torch.log(torch.clamp_min(sv, 1e-12))[None, :]) @ vh.t()
    return out.to(s.device)


def _host_eig(mat: np.ndarray) -> np.ndarray:
    mat = np.asarray(mat, np.float64)
    w, v = np.linalg.eig(mat)
    out = v @ np.diag(w.real) @ np.linalg.inv(v)
    return np.real(out).astype(np.float32)


def _eig_real_transform(s: torch.Tensor) -> torch.Tensor:
    """B diag(Re lambda) B^-1 (model.py:855-859) on the host in float64,
    detached."""
    host = _host_eig(s.detach().cpu().numpy())
    return torch.from_numpy(host).to(s.device)


def adaptive_similarity_loss(vid_emb: torch.Tensor, cap_emb: torch.Tensor,
                             student_vid_emb: torch.Tensor,
                             student_cap_emb: torch.Tensor,
                             mask: torch.Tensor) -> torch.Tensor:
    """huber between the teacher's and the student's similarity matrices,
    weighted by softmax(mask, dim=0) and by 1/|s1| (the teacher's
    magnitudes detached), times B.  The caller detaches the embeddings, so
    that the gradient reaches only the mask."""
    s1 = vid_emb.float() @ cap_emb.float().t()
    s2 = student_vid_emb.float() @ student_cap_emb.float().t()
    weight = torch.softmax(mask, dim=0)
    reweight = 1.0 / (torch.abs(s1.detach()) + 1e-6)
    return torch.sum(reweight * weight * huber(s1, s2)) * mask.shape[0]


def similarity_distill(vid_emb: torch.Tensor, cap_emb: torch.Tensor,
                       student_vid_emb: torch.Tensor,
                       student_cap_emb: torch.Tensor,
                       similarity_type: Optional[str] = None,
                       adapt_weight: Optional[torch.Tensor] = None,
                       reduction: str = "sum") -> torch.Tensor:
    s1 = vid_emb.float() @ cap_emb.float().t()
    s2 = student_vid_emb.float() @ student_cap_emb.float().t()
    if similarity_type == "svd":
        return _reduce(huber(_svd_log_transform(s1),
                             _svd_log_transform(s2)), reduction)
    if similarity_type == "eig":
        return _reduce(huber(_eig_real_transform(s1),
                             _eig_real_transform(s2)), reduction)
    if similarity_type == "diag":
        return torch.sum(torch.diagonal(huber(s1, s2)))
    if similarity_type == "maxdiag":
        return -torch.sum(torch.diagonal(s2))
    if similarity_type == "adapt":
        if adapt_weight is None:
            raise ValueError("'adapt' needs the learned mask weights")
        w = (torch.softmax(adapt_weight, dim=0) if adapt_weight.ndim
             else adapt_weight)
        return torch.sum(w * huber(s1, s2)) * adapt_weight.shape[0]
    return _reduce(huber(s1, s2), reduction)
