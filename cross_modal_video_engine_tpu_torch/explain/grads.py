"""Gradient + activation extraction (torch-hook replacement).

Counterpart of cross_modal_video_engine_tpu/explain/grads.py.  The
reference registers forward/backward hooks on named layers and backprops
the max-class score (MCT/mmaction/utils/get_grads.py:16-146).  Here, as in
the JAX package, the hooks become two calls of the recognizer:

  * activations: `forward_with_capture`, run without a graph;
  * gradients: autograd of the class score THROUGH `score_from_layer`
    (`forward_from`, then the head), evaluated at the captured tokens:
    the backward-hook gradient at that layer.

The gradient starts at the captured fp32 tokens, which `forward_from`
casts to the model's dtype, so it comes back in fp32.  The parameters
keep `requires_grad=False` (`api.init_recognizer` freezes them): no
parameter gradient is built.  On the card the joint blocks' attention
launches the flash kernel forward and its backward recomputes the plain
version (ops/flash_attention, `_PlainBackward`), as the JAX custom_vjp
does.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


def add_capture_methods(recognizer_cls):
    """(kept for API discoverability; Recognizer3D already exposes
    forward_with_capture / score_from_layer)."""
    return recognizer_cls


def capture_forward(model, videos: torch.Tensor, layers: Sequence[int],
                    target_class: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor,
                               Dict[int, torch.Tensor]]:
    """The forward with capture, without a graph: (scores (B, C), the
    class each row's gradient targets (B,), {layer: fp32 tokens}).  The
    class is the argmax of THESE scores: in bf16 a recomputation's argmax
    may differ where two scores nearly tie."""
    with torch.no_grad():
        scores, captured = model.forward_with_capture(videos, tuple(layers))
    if target_class is None:
        cls_idx = scores.argmax(-1)
    else:
        cls_idx = torch.full((scores.shape[0],), target_class,
                             dtype=torch.long, device=scores.device)
    return scores, cls_idx, captured


def class_score_grads(model, captured: Dict[int, torch.Tensor],
                      cls_idx: torch.Tensor, layers: Sequence[int]
                      ) -> Dict[int, torch.Tensor]:
    """{layer: d(sum of each row's cls_idx score) / d(tokens after block
    layer)}, fp32 like the captured tokens.  Grad mode is turned on here,
    whatever the calling thread has set."""
    grads = {}
    with torch.enable_grad():
        for layer in layers:
            tokens = captured[layer].detach().requires_grad_()
            scores = model.score_from_layer(tokens, layer)
            picked = scores.gather(1, cls_idx[:, None]).sum()
            grads[layer], = torch.autograd.grad(picked, tokens)
    return grads


def grad_extract(model, videos: torch.Tensor, layers: Sequence[int],
                 target_class: Optional[int] = None) -> Dict:
    """Reference Grad.__call__ equivalent (get_grads.py:83-146).

    model: Recognizer3D (or compatible: exposes forward_with_capture and
    score_from_layer); videos: (B, T, H, W, 3) on the model's device.
    Returns dict with 'pred' (B,) target class (the argmax unless
    target_class is given), 'scores' (B, C), and per-layer
    'activations'/'gradients' {layer: (B, L, D)}, as float32 numpy."""
    layers = tuple(layers)
    scores, cls_idx, captured = capture_forward(model, videos, layers,
                                                target_class)
    grads = class_score_grads(model, captured, cls_idx, layers)
    return {
        "scores": scores.float().cpu().numpy(),
        "pred": cls_idx.cpu().numpy(),
        "activations": {l: v.cpu().numpy() for l, v in captured.items()},
        "gradients": {l: v.cpu().numpy() for l, v in grads.items()},
    }


def normalized_cls_grad(grad_tokens: np.ndarray) -> np.ndarray:
    """inference_demo.py:309: grad of the CLS token, batch-meaned and
    L2-normalized -> the probe direction for concept scoring."""
    g = grad_tokens[:, 0].mean(axis=0)
    n = np.linalg.norm(g)
    return g / n if n > 0 else g
