"""Label-sequence decoder head for caption generation, in PyTorch.

Counterpart of cross_modal_video_engine_tpu/models/decoder_head.py
(`RNNDecoderHead`): a GRU over the pooled encoder feature that emits
sigmoid multi-label probabilities per step.

* train mode: teacher forcing; step 0 feeds the learned start embedding,
  step i > 0 feeds `targets_emb[:, i]`;
* inference mode: greedy feedback; step i > 0 feeds the previous step's
  probabilities thresholded at `threshold`.

The steps are a Python loop over `max_len` (the JAX package's lax.scan).
The GRU input is concat(current labels, encoder feature).  All of it runs
in fp32 on the parameters' values, as the JAX head does: its encoder
feature is fp32, so the products promote to fp32 even when the
parameters were cast to bf16.  In train mode (`self.training`, the JAX
head's `train=True`) each step's GRU input is dropped elementwise with
probability `input_dropout_p` and scaled by 1/keep, drawn from
`generator` (None: torch's default generator).  The head is built in
eval mode, the JAX default.

Parameter names are those of the reference head's state dict, which
cross_modal_video_engine_tpu.convert.torch_import.convert_rnn_decoder_head
reads: `start_emb.weight`, `rnn.{weight,bias}_{ih,hh}_l0` (torch GRU gate
order r|z|n) and `out.{weight,bias}`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class RNNDecoderConfig:
    num_classes: int = 400          # output dim per step
    in_channels: int = 768          # encoder feature dim (the GRU width)
    max_len: int = 5
    threshold: float = 0.5
    input_dropout_p: float = 0.1    # train mode only


class GRUCell(nn.Module):
    """One torch GRU layer's parameters (gate order r|z|n, torch.nn.GRU's
    names) applied as a cell, in fp32."""

    def __init__(self, input_size: int, hidden: int, dtype: torch.dtype,
                 device=None):
        super().__init__()

        def param(*shape):
            return nn.Parameter(torch.zeros(*shape, dtype=dtype,
                                            device=device))

        self.weight_ih_l0 = param(3 * hidden, input_size)
        self.weight_hh_l0 = param(3 * hidden, hidden)
        self.bias_ih_l0 = param(3 * hidden)
        self.bias_hh_l0 = param(3 * hidden)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        gx = F.linear(x, self.weight_ih_l0.float(), self.bias_ih_l0.float())
        gh = F.linear(h, self.weight_hh_l0.float(), self.bias_hh_l0.float())
        xr, xz, xn = gx.chunk(3, -1)
        hr, hz, hn = gh.chunk(3, -1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        return (1.0 - z) * n + z * h


class RNNDecoderHead(nn.Module):
    def __init__(self, cfg: RNNDecoderConfig,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.generator = generator
        c, h = cfg.num_classes, cfg.in_channels
        self.start_emb = nn.Embedding(1, c, dtype=dtype, device=device)
        self.rnn = GRUCell(c + h, h, dtype, device)
        self.out = nn.Linear(h, c, dtype=dtype, device=device)
        self.eval()   # the JAX default (train=False); .train() for dropout

    def forward(self, encoder_outputs: torch.Tensor,
                targets_emb: Optional[torch.Tensor] = None,
                mode: str = "train") -> torch.Tensor:
        """encoder_outputs: (B, in_channels); targets_emb: (B, max_len,
        num_classes), required in train mode.  -> per-step sigmoid
        probabilities (B, max_len, num_classes), fp32."""
        cfg = self.cfg
        if mode not in ("train", "inference"):
            raise ValueError(f"mode {mode!r}")
        if mode == "train" and targets_emb is None:
            raise ValueError("train mode feeds targets_emb")
        enc = encoder_outputs.float()
        b = enc.shape[0]
        h = enc.new_zeros((b, cfg.in_channels))
        current = self.start_emb.weight.float().expand(b, cfg.num_classes)
        w_out, b_out = self.out.weight.float(), self.out.bias.float()
        steps = []
        for i in range(cfg.max_len):
            if i > 0:
                current = (targets_emb[:, i].float() if mode == "train"
                           else (steps[-1] > cfg.threshold).float())
            x = torch.cat([current, enc], -1)
            if self.training and cfg.input_dropout_p > 0:
                keep = 1.0 - cfg.input_dropout_p
                mask = torch.rand(x.shape, generator=self.generator,
                                  device=x.device) < keep
                x = torch.where(mask, x / keep, torch.zeros_like(x))
            h = self.rnn(h, x)
            steps.append(torch.sigmoid(F.linear(h, w_out, b_out)))
        return torch.stack(steps, 1)

    def decode_greedy(self, encoder_outputs: torch.Tensor) -> torch.Tensor:
        """Thresholded binary label sequence (B, max_len, C), int32."""
        probs = self(encoder_outputs, mode="inference")
        return (probs > self.cfg.threshold).to(torch.int32)
