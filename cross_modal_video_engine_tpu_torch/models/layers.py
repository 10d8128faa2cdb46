"""Building blocks of the LINAS retrieval model, and flax's BatchNorm for
the 3D-CNN backbones.

Counterpart of cross_modal_video_engine_tpu/models/layers.py.  Each module
keeps the reference torch model's state-dict keys (LINAS-engine/model.py),
so a sub state dict of the reference checkpoint loads as it is:

* `BiGRU` is a bidirectional `nn.GRU` (gate order r|z|n, `*_reverse` for
  the backward direction).  `packed=True`, the text side, runs
  pack_padded_sequence semantics: steps past a row's length carry the
  hidden state, their outputs are zero.  The lengths go to the host for
  packing (one device-to-host copy a call); a row of length 0 is packed
  as length 1 and its outputs zeroed, which is what the JAX model gives.
  `packed=False`, the video side, runs the padded batch as it is, so the
  backward direction steps through the pad rows first.
* `ConvBank1D` holds the reference's `Conv2d(1, K, (w, C), padding=(w-1,
  0))` weights (`{i}.weight` of shape (K, 1, w, C)) and computes them as
  the 1-d convolution they are, then ReLU and the max over time.
* `MFC` is fc1, residual fc blocks, then `bn_1` and dropout (the JAX
  module's `have_bn`/`have_last_bn` options, which no model sets, are
  left out: `bn_1` is always there).  `bn_1` is flax's BatchNorm:
  momentum 0.9 on the running statistics (torch 0.1), eps 1e-5, and in
  train mode the biased batch variance E[x^2] - E[x]^2, for normalizing
  and for the running variance alike.
* `LatentMapping` is MFC and the L2 norm into the common space.
* `Dropout` draws its mask from the module's `generator` (None: torch's
  default generator), which a trainer seeds, or takes the next of the
  keep masks handed to it (`masks`, an iterator a step sets).
* `FlaxBatchNorm` is flax's `nn.BatchNorm` over the channel axis of an
  input of any rank (N, C, ...), for the 3D-CNN backbones
  (models/resnet3d.py): flax's momentum 0.9 (torch 0.1), eps 1e-5 (CSN's
  1e-3); in train mode it normalizes by the batch statistics and moves
  the running variance by the biased batch variance; in eval mode it
  normalizes by the running statistics.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from ..ops.similarity import l2norm


class BiGRU(nn.GRU):
    """x: (B, T, D); lengths: (B,) valid steps (packed mode only).
    Returns (B, T, 2H) f32."""

    def __init__(self, input_size: int, hidden_size: int,
                 packed: bool = False, device=None):
        super().__init__(input_size, hidden_size, batch_first=True,
                         bidirectional=True, device=device)
        self.packed = packed

    def forward(self, x: torch.Tensor,
                lengths: torch.Tensor = None) -> torch.Tensor:
        if not self.packed:
            return super().forward(x)[0]
        T = x.shape[1]
        host_len = lengths.to("cpu", torch.int64)
        seq = pack_padded_sequence(x, host_len.clamp_min(1),
                                   batch_first=True, enforce_sorted=False)
        out, _ = pad_packed_sequence(super().forward(seq)[0],
                                     batch_first=True, total_length=T)
        valid = torch.arange(T, device=x.device)[None, :] < \
            lengths.to(x.device)[:, None]
        return out * valid[..., None]


class ConvBank1D(nn.ModuleList):
    """Multi-window temporal conv bank + ReLU + max over time.
    x: (B, T, C) -> (B, kernel_num * len(kernel_sizes))."""

    def __init__(self, in_channels: int, kernel_num: int,
                 kernel_sizes: Sequence[int] = (2, 3, 4, 5), device=None):
        super().__init__([
            nn.Conv2d(1, kernel_num, (w, in_channels), padding=(w - 1, 0),
                      device=device) for w in kernel_sizes])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xt = x.transpose(1, 2)                           # (B, C, T)
        outs = []
        for conv in self:
            w = conv.weight.shape[2]
            weight = conv.weight[:, 0].transpose(1, 2)   # (K, C, w)
            y = F.relu(F.conv1d(xt, weight, conv.bias, padding=w - 1))
            outs.append(y.amax(dim=2))                   # max over time
        return torch.cat(outs, dim=1)


class Dropout(nn.Dropout):
    """flax's Dropout: in train mode keep each element with probability
    1 - p, drawn from `generator`, and scale it by 1 / (1 - p)."""

    generator = None
    # an iterator of keep masks handed in (one per call, in call order)
    masks = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.p == 1.0:
            return torch.zeros_like(x)
        keep_prob = 1.0 - self.p
        if self.masks is not None:
            keep = torch.as_tensor(next(self.masks), device=x.device)
            if keep.shape != x.shape:
                raise ValueError(f"a handed-in dropout mask of "
                                 f"{tuple(keep.shape)} for {tuple(x.shape)}")
        else:
            keep = torch.rand(x.shape, generator=self.generator,
                              device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, 0.0)


class FlaxBatchNorm1d(nn.BatchNorm1d):
    """BatchNorm1d with flax's statistics (see the module docstring); eval
    mode normalizes by the running statistics, as torch does."""

    def __init__(self, num_features: int, device=None):
        super().__init__(num_features, eps=1e-5, momentum=0.1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        mean = x.mean(dim=0)
        var = torch.clamp_min((x * x).mean(dim=0) - mean * mean, 0.0)
        with torch.no_grad():
            self.running_mean.mul_(1 - self.momentum).add_(
                self.momentum * mean)
            self.running_var.mul_(1 - self.momentum).add_(
                self.momentum * var)
            self.num_batches_tracked.add_(1)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


class FlaxBatchNorm(nn.modules.batchnorm._BatchNorm):
    """flax's BatchNorm over dim 1 of an (N, C, ...) input of any rank.
    The normalization is torch's (cuDNN on the card); after torch's update
    rv' = (1 - m) rv + m var n/(n-1) of the running variance, the excess
    over flax's update by the biased variance is taken back out:
    rv = (1 - m) rv + (rv' - (1 - m) rv) (n-1)/n, the method of
    models/yolo.BatchNorm.  A bf16 input keeps f32 weights and statistics
    (torch's mixed-type batch norm), as flax computes its statistics in
    f32; the output is the input's dtype.  `count_batches` False leaves
    num_batches_tracked at 0 (a state that resumes from the JAX format,
    which keeps no count, then equals an uninterrupted one)."""

    count_batches = True

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, device=None):
        super().__init__(num_features, eps=eps, momentum=momentum,
                         device=device)

    def _check_input_dim(self, x: torch.Tensor) -> None:
        if x.dim() < 2:
            raise ValueError(f"expected an (N, C, ...) input, got {x.dim()}-d")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        n = x.numel() // x.shape[1]
        # torch updates copies (autograd keeps them for the backward)
        mean, var = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True,
                         self.momentum, self.eps)
        with torch.no_grad():
            kept = self.running_var * (1.0 - self.momentum)
            self.running_mean.copy_(mean)
            self.running_var.copy_(kept + (var - kept) * ((n - 1) / n))
            if self.count_batches:
                self.num_batches_tracked.add_(1)
        return y


class MFC(nn.Module):
    """FC stack: fc1 -> [ + relu(fc_i) residuals ] -> bn_1 -> dropout."""

    def __init__(self, in_features: int, out_features: Sequence[int],
                 dropout_rate: float = 0.2, device=None):
        super().__init__()
        self.n_fc = len(out_features)
        dims = [in_features] + list(out_features)
        for i in range(self.n_fc):
            setattr(self, f"fc{i + 1}",
                    nn.Linear(dims[i], dims[i + 1], device=device))
        self.bn_1 = (FlaxBatchNorm1d(dims[-1], device=device)
                     if self.n_fc else None)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.n_fc:
            return x
        features = self.fc1(x)
        for i in range(2, self.n_fc + 1):
            features = features + F.relu(getattr(self, f"fc{i}")(features))
        return self.dropout(self.bn_1(features))


class LatentMapping(nn.Module):
    """MFC + L2 normalization into the common space."""

    def __init__(self, in_features: int, out_features: Sequence[int],
                 dropout_rate: float = 0.2, device=None):
        super().__init__()
        self.mapping = MFC(in_features, out_features, dropout_rate,
                           device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return l2norm(self.mapping(x))
