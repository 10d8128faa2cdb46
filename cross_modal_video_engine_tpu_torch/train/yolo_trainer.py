"""The detector's training numerics, and the letterbox of its batches.

Counterpart of cross_modal_video_engine_tpu/train/yolo_trainer.py
(MCT/yolov5/train.py and classify/train.py):

* three parameter groups (smart_optimizer): convolution and linear
  kernels take weight decay (group 0), BatchNorm scales (group 1) and
  every bias (group 2) do not.  The groups are read off the owning
  module, not the name: in the ultralytics layout a BatchNorm's scale is
  called `.weight`;
* nesterov SGD with coupled decay on group 0 and the bias lr on group 2:
  g += wd * p (group 0); v = m * v + g; p -= lr * (g + m * v);
* `scaled_weight_decay`: wd * batch * accumulate / 64;
* `lr_momentum_at`: warmup over max(3 epochs, 100 iterations) (the bias
  lr falls from 0.1, the others rise from 0, the momentum rises 0.8 ->
  0.937), then the linear or one-cycle cosine epoch schedule;
* ModelEMA: d = 0.9999 * (1 - exp(-updates / 2000)) with `updates`
  counted after the increment, over the parameters and the BatchNorm
  statistics.

`YoloTrainState(model, vel, ema, updates)` holds what the JAX
YoloTrainState holds: the model carries params and batch_stats (f32
masters), `vel` the momentum buffers by parameter name, `ema` a second
model of the same config with ema_params and ema_stats.  A step updates
them in place and returns the state with `updates + 1`.  `bf16=True`
keeps the f32 masters, velocity and EMA, and runs the forward and
backward on a bfloat16 copy of the parameters and images
(`torch.func.functional_call` on a parameterless copy of the model, the
casts inside autograd); the BatchNorms keep f32 scales, biases and
statistics, as flax computes them in f32, and their running statistics
update the masters' buffers in place.  The maps and prototypes enter the
loss in f32.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.pipelines import resize_linear
from ..losses.yolo import YoloHyp, scale_hyp, yolo_loss, yolo_seg_loss
from ..models.yolo import (BatchNorm, YoloClassifier, YoloV5,
                           init_state_dict)
from ..utils.precision import no_tf32
from .recognition_trainer import _check


class YoloOptHyp(NamedTuple):
    """Optimizer and schedule hyperparameters (hyp.scratch-low.yaml)."""
    lr0: float = 0.01
    lrf: float = 0.01
    momentum: float = 0.937
    weight_decay: float = 0.0005
    warmup_epochs: float = 3.0
    warmup_momentum: float = 0.8
    warmup_bias_lr: float = 0.1
    cos_lr: bool = False
    ema_decay: float = 0.9999
    ema_tau: float = 2000.0


class YoloTrainState(NamedTuple):
    model: nn.Module               # params and batch_stats
    vel: Dict[str, torch.Tensor]   # SGD momentum buffers
    ema: nn.Module                 # ema_params and ema_stats
    updates: int                   # EMA update counter


def param_groups(model: nn.Module) -> Dict[str, int]:
    """smart_optimizer's groups by parameter name: 0 decayed kernels,
    1 BatchNorm scales, 2 biases."""
    groups = {}
    for owner, mod in model.named_modules():
        for leaf, _ in mod.named_parameters(recurse=False):
            name = f"{owner}.{leaf}" if owner else leaf
            if leaf == "bias":
                groups[name] = 2
            elif isinstance(mod, BatchNorm):
                groups[name] = 1
            else:
                groups[name] = 0
    return groups


def lr_momentum_at(ni: int, epoch: int, nb: int, epochs: int,
                   opt: YoloOptHyp) -> Tuple[float, float, float]:
    """(lr_bias, lr_rest, momentum) at integrated batch `ni`."""
    if opt.cos_lr:
        lf = ((1 - math.cos(epoch * math.pi / epochs)) / 2) \
            * (opt.lrf - 1.0) + 1.0
    else:
        lf = (1 - epoch / epochs) * (1.0 - opt.lrf) + opt.lrf
    lr = opt.lr0 * lf
    nw = max(round(opt.warmup_epochs * nb), 100)
    if ni <= nw:
        f = ni / max(nw, 1)
        lr_bias = opt.warmup_bias_lr + (lr - opt.warmup_bias_lr) * f
        lr_rest = lr * f
        mom = opt.warmup_momentum + (opt.momentum - opt.warmup_momentum) * f
    else:
        lr_bias = lr_rest = lr
        mom = opt.momentum
    return lr_bias, lr_rest, mom


def scaled_weight_decay(opt: YoloOptHyp, batch_size: int) -> float:
    """train.py:153-155: the decay scales with the effective batch."""
    accumulate = max(round(64 / batch_size), 1)
    return opt.weight_decay * batch_size * accumulate / 64.0


def _float_buffers(model: nn.Module) -> Dict[str, torch.Tensor]:
    return {n: b for n, b in model.named_buffers()
            if b.is_floating_point() and not n.endswith("anchors")}


def init_yolo_train_state(model: nn.Module, seed: int = 0,
                          state_dict: Optional[Dict[str, torch.Tensor]] = None
                          ) -> YoloTrainState:
    """The state at step 0: the model loaded with `state_dict` (or the
    training init `models/yolo.init_state_dict` draws from `seed`), zero
    velocity, the EMA a copy of the model, updates 0."""
    classifier = isinstance(model, YoloClassifier)
    if state_dict is None:
        state_dict = init_state_dict(model.cfg, seed, classifier=classifier)
    model.load_state_dict(state_dict)
    dev = next(model.parameters()).device
    ema = type(model)(model.cfg, device=dev)
    ema.load_state_dict(model.state_dict())
    vel = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    return YoloTrainState(model, vel, ema, 0)


def _bf16_forward(model: nn.Module):
    """forward(images) -> the model's outputs computed in bfloat16: a
    parameterless copy of the model (meta device) called on bf16 copies
    of the master parameters (the BatchNorms' rounded to bf16 and held
    in f32), the masters' f32 buffers and the images in bf16."""
    shadow = type(model)(model.cfg, device="meta")
    bn = {f"{o}.{leaf}" for o, m in model.named_modules()
          if isinstance(m, BatchNorm) for leaf in ("weight", "bias")}

    def forward(images: torch.Tensor):
        shadow.train(model.training)
        tensors = {n: (p.to(torch.bfloat16).float() if n in bn
                       else p.to(torch.bfloat16))
                   for n, p in model.named_parameters()}
        tensors.update(model.named_buffers())
        return torch.func.functional_call(
            shadow, tensors, (images.to(torch.bfloat16),))

    return forward


def _sgd_ema_update(state: YoloTrainState, groups: Dict[str, int],
                    opt: YoloOptHyp, weight_decay: float, lr_bias: float,
                    lr_rest: float, momentum: float) -> YoloTrainState:
    """The shared optimizer numerics of every YOLO step: three-group
    nesterov SGD (coupled decay on group 0, the bias lr on group 2), then
    the ramped EMA over parameters and BatchNorm statistics."""
    net = state.model
    named = dict(net.named_parameters())
    with torch.no_grad():
        for grp in (0, 1, 2):
            names = [n for n, g in groups.items() if g == grp]
            if not names:
                continue
            ps = [named[n] for n in names]
            gs = [named[n].grad if named[n].grad is not None
                  else torch.zeros_like(named[n]) for n in names]
            vs = [state.vel[n] for n in names]
            if grp == 0:
                gs = torch._foreach_add(gs, ps, alpha=weight_decay)
            torch._foreach_mul_(vs, momentum)
            torch._foreach_add_(vs, gs)
            upd = torch._foreach_add(gs, vs, alpha=momentum)
            torch._foreach_add_(ps, upd,
                                alpha=-(lr_bias if grp == 2 else lr_rest))
        updates = state.updates + 1
        d = float(np.float32(opt.ema_decay) * (np.float32(1.0) - np.exp(
            np.float32(-updates / opt.ema_tau))))
        ema_p = dict(state.ema.named_parameters())
        ema_b = _float_buffers(state.ema)
        new_b = _float_buffers(net)
        es = [ema_p[n] for n in named] + [ema_b[n] for n in new_b]
        xs = list(named.values()) + list(new_b.values())
        torch._foreach_mul_(es, d)
        torch._foreach_add_(es, xs, alpha=1.0 - d)
    return state._replace(updates=updates)


def _zero_grads(model: nn.Module) -> None:
    for p in model.parameters():
        p.grad = None


def make_yolo_train_step(model: YoloV5, hyp: YoloHyp, opt: YoloOptHyp,
                         weight_decay: float, bf16: bool = False,
                         mask_cap: int = 128, device=None):
    """step(state, images, targets, valid, lr_bias, lr_rest, momentum,
    gt_masks=None) -> (state, {"loss", "box", "obj", "cls"[, "seg",
    "seg_dropped"]}) on `device` (None: the CUDA device), where the model
    must lie.  images (B, H, W, 3) f32 in [0, 1]; targets (B, T, 5)
    normalized [cls, cx, cy, w, h] with valid (B, T); for a segment head
    gt_masks (B, T, H/4, W/4).  The anchors are the model config's at
    each call (a resumed run's AutoAnchor result).  logs: detached 0-d
    tensors."""
    _check(model, device)
    no_tf32()
    cfg = model.cfg
    seg = cfg.masks > 0
    loss_hyp = scale_hyp(hyp, nl=3, nc=cfg.num_classes, imgsz=cfg.img_size)
    forward = _bf16_forward(model) if bf16 else model
    groups = param_groups(model)

    def step(state: YoloTrainState, images, targets, valid, lr_bias,
             lr_rest, momentum, gt_masks=None):
        net = state.model
        if net is not model:
            raise ValueError("the state's model is not the one the step "
                             "was made for")
        net.train()
        _zero_grads(net)
        out = forward(images)
        if seg:
            raw, proto = out
            total, items = yolo_seg_loss(
                [m.float() for m in raw], proto.float(), targets, valid,
                gt_masks, net.cfg.anchors, hyp=loss_hyp,
                num_classes=cfg.num_classes, nm=cfg.masks,
                mask_cap=mask_cap)
        else:
            total, items = yolo_loss([m.float() for m in out], targets,
                                     valid, net.cfg.anchors, hyp=loss_hyp,
                                     num_classes=cfg.num_classes)
        total.backward()
        state = _sgd_ema_update(state, groups, opt, weight_decay,
                                float(lr_bias), float(lr_rest),
                                float(momentum))
        logs = {"loss": total.detach()}
        logs.update({k: v.detach() for k, v in items.items()})
        return state, logs

    return step


def make_yolo_cls_train_step(model: YoloClassifier, opt: YoloOptHyp,
                             weight_decay: float,
                             label_smoothing: float = 0.1,
                             bf16: bool = False, device=None):
    """step(state, images, labels, lr_bias, lr_rest, momentum) -> (state,
    {"loss", "acc"}): label-smoothed cross entropy over the f32 logits,
    the same groups, SGD and EMA as the detection step."""
    _check(model, device)
    no_tf32()
    forward = _bf16_forward(model) if bf16 else model
    groups = param_groups(model)

    def step(state: YoloTrainState, images, labels, lr_bias, lr_rest,
             momentum):
        net = state.model
        if net is not model:
            raise ValueError("the state's model is not the one the step "
                             "was made for")
        net.train()
        _zero_grads(net)
        logits = forward(images).float()
        nc = logits.shape[-1]
        smoothed = (F.one_hot(labels.long(), nc).float()
                    * (1.0 - label_smoothing) + label_smoothing / nc)
        loss = -(smoothed * torch.log_softmax(logits, -1)).sum(-1).mean()
        acc = (logits.argmax(-1) == labels).float().mean()
        loss.backward()
        state = _sgd_ema_update(state, groups, opt, weight_decay,
                                float(lr_bias), float(lr_rest),
                                float(momentum))
        return state, {"loss": loss.detach(), "acc": acc.detach()}

    return step


def state_tensors(state: YoloTrainState) -> Dict[str, Dict[str, torch.Tensor]]:
    """The state's tensors by part, detached: params, batch_stats, vel,
    ema_params, ema_stats (for comparisons and checkpoints)."""
    net, ema = state.model, state.ema
    return {"params": {n: p.detach() for n, p in net.named_parameters()},
            "batch_stats": _float_buffers(net),
            "vel": dict(state.vel),
            "ema_params": {n: p.detach() for n, p in ema.named_parameters()},
            "ema_stats": _float_buffers(ema)}


# -- the letterbox of the batches ---------------------------------------------

def letterbox(img: np.ndarray, new: int = 640,
              color: int = 114) -> Tuple[np.ndarray, float, Tuple[int, int]]:
    """(H, W, C) -> (new, new, C): resized by r = min(new/H, new/W) with
    data/pipelines.resize_linear (cv2.resize's uint8 INTER_LINEAR), padded
    with `color` (half each side, the odd pixel to the bottom/right) by
    np.pad in place of cv2.copyMakeBorder.  Returns the image, r and the
    (dx, dy) pad in pixels."""
    h, w = img.shape[:2]
    r = min(new / h, new / w)
    nh, nw = round(h * r), round(w * r)
    if (nh, nw) != (h, w):
        img = resize_linear(img, (nw, nh))
    dy, dx = (new - nh) / 2, (new - nw) / 2
    top, bottom = int(round(dy - 0.1)), int(round(dy + 0.1))
    left, right = int(round(dx - 0.1)), int(round(dx + 0.1))
    pad = [(top, bottom), (left, right)] + [(0, 0)] * (img.ndim - 2)
    out = np.pad(img, pad, mode="constant", constant_values=color)
    return out, r, (left, top)


def letterbox_boxes(boxes: np.ndarray, r: float, pad: Tuple[float, float],
                    orig_hw: Tuple[int, int], new: int) -> np.ndarray:
    """Map normalized [cls, cx, cy, w, h] label rows through the
    `letterbox` geometry."""
    if len(boxes) == 0:
        return boxes
    h, w = orig_hw
    out = boxes.copy()
    out[:, 1] = (boxes[:, 1] * w * r + pad[0]) / new
    out[:, 2] = (boxes[:, 2] * h * r + pad[1]) / new
    out[:, 3] = boxes[:, 3] * w * r / new
    out[:, 4] = boxes[:, 4] * h * r / new
    return out
