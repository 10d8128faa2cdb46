"""Recognition and caption training on the TimeSformer recognizers.

Counterpart of cross_modal_video_engine_tpu/train/recognition_trainer.py
(MCT apis/train.py) for the TimeSformer family:

* `RecognitionTrainConfig`, field for field;
* `RecTrainState(model, optimizer, step)`: the model holds the float32
  master parameters, the optimizer (train/optim.OptaxOptimizer) its count
  and moments; a step updates both in place and returns the state with
  `step + 1`, as the JAX step returns its new state;
* `make_rec_optimizer`: optax's chains of `make_rec_optimizer`
  (clip_by_global_norm, then SGD with momentum and decoupled weight decay
  on every parameter, or AdamW; a warmup-cosine schedule when
  warmup_steps > 0), as a factory of `OptaxOptimizer`s;
* `make_cls_train_step`: cross entropy over the class scores in f32,
  with top-1 accuracy; `bf16=True` keeps the f32 masters and runs the
  forward and backward on a bfloat16 copy of the parameters and videos
  (a backbone configured in bfloat16, through `torch.func.functional_call`
  with the casts inside autograd), the scores in f32, the gradients back
  in f32: the JAX step's `_cast_tree` (mmcv's Fp16OptimizerHook);
* `make_seq_train_step`: the SeqMLL loss with teacher forcing
  (`Recognizer3DRelseq.forward_train`);
* `evaluate_classification`: top-1/top-5 and mean class accuracy.

A step runs the model in train mode: DropPath, the embedding dropouts and
the decoder's input dropout draw from the `torch.Generator` given to the
step's maker.  A backbone configured in bfloat16 trained without
`bf16=True` is refused: there the JAX package's f32 parameters promote
the products of its `Dense(dtype=None)` layers back to f32 (ROADMAP.md
queue 1 item 14).  The BatchNorm families' `*_stats` steps, multigrid,
OmniSource and mixup/cutmix blending come with slice 5 (queue 1 item 8).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Iterable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..metrics.accuracy import mean_class_accuracy, top_k_accuracy
from ..models.decoder_head import RNNDecoderHead
from ..models.layers import Dropout
from ..models.recognizer import Recognizer3D, Recognizer3DRelseq
from ..models.timesformer import DropPath
from ..utils.device import resolve_device
from ..utils.precision import no_tf32
from .optim import OptaxOptimizer

SLICE5 = ("{} is not ported yet: the BatchNorm families, multigrid, "
          "OmniSource and blending come with slice 5 (ROADMAP.md queue 1 "
          "item 8)")
BF16_CONFIG = ("a backbone configured with dtype='bfloat16' trains with "
               "bf16=True (f32 masters, a bf16 copy for the forward); "
               "without it the JAX package's f32 parameters promote its "
               "Dense products back to f32, which is not ported "
               "(ROADMAP.md queue 1 item 14)")


@dataclasses.dataclass(frozen=True)
class RecognitionTrainConfig:
    optimizer: str = "sgd"           # | 'adamw'
    learning_rate: float = 0.005
    momentum: float = 0.9
    weight_decay: float = 1e-4
    grad_clip: float = 40.0          # mmaction grad_clip=dict(max_norm=40)
    num_epochs: int = 15
    eval_interval: int = 1
    warmup_steps: int = 0
    # bf16 forward/backward with f32 master parameters
    bf16: bool = False


class RecTrainState(NamedTuple):
    model: torch.nn.Module           # the f32 master parameters
    optimizer: OptaxOptimizer
    step: int


def make_rec_optimizer(cfg: RecognitionTrainConfig, total_steps: int = 10000
                       ) -> Callable[[Iterable], OptaxOptimizer]:
    """named_params -> the OptaxOptimizer of optax's
    chain(clip_by_global_norm(grad_clip), add_decayed_weights(wd),
    sgd(lr, momentum)), or of chain(clip, adamw(lr, weight_decay=wd)) for
    optimizer='adamw'; no clip at grad_clip <= 0; lr the warmup-cosine
    schedule over total_steps when warmup_steps > 0."""
    kind = "adamw" if cfg.optimizer == "adamw" else "sgd"
    return functools.partial(
        OptaxOptimizer, lr=cfg.learning_rate, kind=kind,
        max_norm=cfg.grad_clip if cfg.grad_clip > 0 else None,
        weight_decay=cfg.weight_decay,
        momentum=cfg.momentum if kind == "sgd" else None,
        warmup_steps=cfg.warmup_steps, total_steps=total_steps)


def init_rec_state(model: torch.nn.Module, tx) -> RecTrainState:
    """The state at step 0: tx (make_rec_optimizer's factory) over the
    model's parameters."""
    return RecTrainState(model, tx(list(model.named_parameters())), 0)


def set_generator(model: torch.nn.Module,
                  generator: Optional[torch.Generator]) -> None:
    """Every DropPath, dropout and decoder input dropout of the model
    draws from `generator`."""
    for m in model.modules():
        if isinstance(m, (DropPath, Dropout, RNNDecoderHead)):
            m.generator = generator


def _check(model: torch.nn.Module, device) -> None:
    dev = resolve_device(device)
    at = next(model.parameters()).device
    if at.type != dev.type or (dev.index is not None
                               and at.index != dev.index):
        raise ValueError(f"the model is on {at}, the step was asked to run "
                         f"on {dev} (device=None means the CUDA device; "
                         f"pass device='cpu' for the CPU)")


def _bf16_forward(model: Recognizer3D,
                  generator: Optional[torch.Generator]):
    """forward(videos) -> f32 scores of the model's function computed in
    bfloat16: a parameterless copy of the model configured in bfloat16
    (on the meta device) called on the master parameters and the videos
    cast to bfloat16 inside autograd, so each gradient returns to its
    f32 master as f32."""
    cfg = dataclasses.replace(model.backbone.cfg, dtype="bfloat16")
    shadow = Recognizer3D(cfg, model.cls_head.fc_cls.out_features,
                          device="meta")
    set_generator(shadow, generator)

    def forward(videos: torch.Tensor) -> torch.Tensor:
        shadow.train(model.training)
        params = {n: p.to(torch.bfloat16)
                  for n, p in model.named_parameters()}
        return torch.func.functional_call(
            shadow, params, (videos.to(torch.bfloat16),))

    return forward


def make_cls_train_step(model: Recognizer3D, blending=None,
                        bf16: bool = False,
                        generator: Optional[torch.Generator] = None,
                        device=None):
    """step(state, videos, labels) -> (state, {"loss", "top1_acc"}): one
    forward in train mode, backward and optimizer step on `device` (None:
    the CUDA device), where the model must lie.  labels: int64 class
    indices.  logs: detached 0-d tensors."""
    if blending is not None:
        raise NotImplementedError(SLICE5.format("blending (data/blending)"))
    if not isinstance(model, Recognizer3D):
        raise NotImplementedError(SLICE5.format(type(model).__name__))
    _check(model, device)
    dtype = model.backbone.cfg.dtype
    if bf16 and dtype != "float32":
        raise ValueError("bf16=True keeps float32 masters: build the model "
                         "with dtype='float32'")
    if dtype == "bfloat16":
        raise NotImplementedError(BF16_CONFIG)
    no_tf32()
    set_generator(model, generator)
    forward = _bf16_forward(model, generator) if bf16 else model

    def step(state: RecTrainState, videos: torch.Tensor,
             labels: torch.Tensor):
        net, opt = state.model, state.optimizer
        if net is not model:
            raise ValueError("the state's model is not the one the step "
                             "was made for")
        net.train()
        opt.zero_grad(set_to_none=True)
        scores = forward(videos).float()
        loss = F.cross_entropy(scores, labels)
        acc = (scores.argmax(-1) == labels).float().mean()
        loss.backward()
        opt.step()
        return (state._replace(step=state.step + 1),
                {"loss": loss.detach(), "top1_acc": acc.detach()})

    return step


def make_seq_train_step(model: Recognizer3DRelseq,
                        generator: Optional[torch.Generator] = None,
                        device=None):
    """step(state, videos, targets_emb, mask) -> (state, {"loss"}): the
    teacher-forced SeqMLL loss in train mode, backward and optimizer step
    on `device` (None: the CUDA device).  logs: detached 0-d tensors."""
    if not isinstance(model, Recognizer3DRelseq):
        raise NotImplementedError(SLICE5.format(type(model).__name__))
    _check(model, device)
    if model.backbone.cfg.dtype == "bfloat16":
        raise NotImplementedError(BF16_CONFIG)
    no_tf32()
    set_generator(model, generator)

    def step(state: RecTrainState, videos: torch.Tensor,
             targets_emb: torch.Tensor, mask: torch.Tensor):
        net, opt = state.model, state.optimizer
        if net is not model:
            raise ValueError("the state's model is not the one the step "
                             "was made for")
        opt.zero_grad(set_to_none=True)
        loss = net.forward_train(videos, targets_emb, mask)
        loss.backward()
        opt.step()
        return state._replace(step=state.step + 1), {"loss": loss.detach()}

    return step


def evaluate_classification(model: Recognizer3D, batches) -> Dict:
    """batches: iterable of (videos, labels, n_valid) on the model's
    device.  Runs the model in eval mode without a graph; returns
    mmaction's top1_acc, top5_acc and mean_class_accuracy over the valid
    rows."""
    model.eval()
    scores, labels = [], []
    with torch.no_grad():
        for videos, lab, n in batches:
            scores.extend(model(videos).float().cpu().numpy()[:n])
            labels.extend(torch.as_tensor(lab)[:n].tolist())
    top1, top5 = top_k_accuracy(scores, labels,
                                (1, min(5, scores[0].shape[0])))
    return {"top1_acc": top1, "top5_acc": top5,
            "mean_class_accuracy": mean_class_accuracy(scores, labels)}


# -- slice 5 -------------------------------------------------------------------

def _slice5(name: str):
    def raise_(*args, **kwargs):
        raise NotImplementedError(SLICE5.format(name))
    raise_.__name__ = name
    raise_.__doc__ = f"Raises: {SLICE5.format(name)}."
    return raise_


make_cls_train_step_stats = _slice5("make_cls_train_step_stats")
make_seq_train_step_stats = _slice5("make_seq_train_step_stats")
make_tpn_train_step_stats = _slice5("make_tpn_train_step_stats")
train_multigrid = _slice5("train_multigrid")
train_omnisource = _slice5("train_omnisource")
