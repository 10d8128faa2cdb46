"""Space-to-depth stem conv: the 7x7 stride-2 stem as one stride-4 conv.

Counterpart of cross_modal_video_engine_tpu/ops/s2d_stem.py
(`s2d_kernel`, `s2d_stem_conv`), in the port's NCDHW layout:

    y[b, c, t, 2Y+dy, 2X+dx] = conv7x7_s2(x, w)[b, c, t, 2Y+dy, 2X+dx]
                             = conv9x9_s4(x, w9)[b, (2dy+dx)*cout+c, t, Y, X]

with w9[(2dy+dx)*cout+c, i, kt, ky, kx] = w[c, i, kt, ky-2dy, kx-2dx]
(zero outside): the 2x2 output block's four receptive fields span 9x9
input pixels, so the stride-4 kernel is the stride-2 kernel shifted into
the four quadrant offsets.  The same weights, so the outputs (and the
gradient, through pad and cat) equal the plain conv's up to the order of
the sums.  The stem's parameter is the plain conv's (kt, 7, 7) kernel: a
checkpoint loads with the flag on or off.  `SlowFastConfig.fast_s2d_stem`
(on in configs/recognition/slowfast_r50_4x16_k400.py) and
`ResNet3DConfig.s2d_stem` route the stem through it; a cuDNN call, no
kernel of the port's own.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def s2d_kernel(w: torch.Tensor) -> torch.Tensor:
    """(cout, cin, kt, 7, 7) stride-2 kernel -> the equivalent
    (4 cout, cin, kt, 9, 9) stride-4 kernel, quadrants in row-major
    order (dy, dx) = (0, 0), (0, 1), (1, 0), (1, 1)."""
    assert w.shape[3] == 7 and w.shape[4] == 7, tuple(w.shape)
    return torch.cat([F.pad(w, (2 * dx, 2 - 2 * dx, 2 * dy, 2 - 2 * dy))
                      for dy in (0, 1) for dx in (0, 1)], 0)


def s2d_stem_conv(x: torch.Tensor, w: torch.Tensor, *,
                  stride_t: int = 1) -> torch.Tensor:
    """Exactly F.conv3d(x, w, stride=(stride_t, 2, 2), padding=(kt // 2,
    3, 3)), as one stride-4 9x9 conv with 4x the output channels and a
    depth-to-space.  x: (B, cin, T, H, W) with H and W multiples of 4
    (asserted, as the JAX function does); w: the (cout, cin, kt, 7, 7)
    stem kernel the plain path trains."""
    cout, kt = w.shape[0], w.shape[2]
    B, _, T, H, W = x.shape
    assert H % 4 == 0 and W % 4 == 0, (H, W)
    # spatial (3, 2): output column X reads input 4X-3 .. 4X+5; the plain
    # conv's (3, 3) right pad has one column no output reads
    xp = F.pad(x, (3, 2, 3, 2, kt // 2, kt // 2))
    y = F.conv3d(xp, s2d_kernel(w).to(x.dtype), stride=(stride_t, 4, 4))
    To, Ho, Wo = y.shape[2:]
    y = y.reshape(B, 2, 2, cout, To, Ho, Wo)           # (dy, dx, c)
    y = y.permute(0, 3, 4, 5, 1, 6, 2)                 # (c, t, Y, dy, X, dx)
    return y.reshape(B, cout, To, Ho * 2, Wo * 2)
