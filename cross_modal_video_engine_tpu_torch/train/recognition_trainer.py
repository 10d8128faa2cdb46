"""Recognition and caption training on the TimeSformer, CNN, transformer
and CLIP recognizers.

Counterpart of cross_modal_video_engine_tpu/train/recognition_trainer.py
(MCT apis/train.py):

* `RecognitionTrainConfig`, field for field;
* `RecTrainState(model, optimizer, step)`: the model holds the float32
  master parameters (and a 3D-CNN's BatchNorm statistics in its
  buffers), the optimizer (train/optim.OptaxOptimizer) its count and
  moments; a step updates both in place and returns the state with
  `step + 1`, as the JAX step returns its new state;
* `make_rec_optimizer`: optax's chains of `make_rec_optimizer`
  (clip_by_global_norm, then SGD with momentum and decoupled weight decay
  on every parameter, BatchNorm scales included, or AdamW; a
  warmup-cosine schedule when warmup_steps > 0), as a factory of
  `OptaxOptimizer`s;
* `make_cls_train_step`: cross entropy over the class scores in f32,
  with top-1 accuracy; `bf16=True` keeps the f32 masters and runs the
  forward and backward on a bfloat16 copy of the parameters and videos
  (a backbone configured in bfloat16, through `torch.func.functional_call`
  with the casts inside autograd), the scores in f32, the gradients back
  in f32: the JAX step's `_cast_tree` (mmcv's Fp16OptimizerHook);
* `make_cls_train_step` also trains the recognizers without BatchNorm
  (`BackboneClassifier` over Swin3D, MViT, VideoMAEViT or VideoCLIP's
  pooled encoder, and `Recognizer3DCLIP`): their parameters are f32
  masters, and `bf16=True` calls the model itself through
  `functional_call` on bf16 copies of them and the videos, each layer then
  computing in the dtype flax would (models/flax_nn.py), as the JAX
  step's `_cast_tree` does;
* `make_seq_train_step`: the SeqMLL loss with teacher forcing
  (`Recognizer3DRelseq.forward_train`, or a `RecognizerRelseq` on a
  backbone without BatchNorm);
* `make_cls_train_step_stats` and `make_seq_train_step_stats`: the same
  for the BatchNorm recognizers (BackboneClassifier and X3DClassifier
  over models/resnet3d.py's and backbones2d.py's pooled backbones,
  Recognizer2D over the per-frame ones, RecognizerRelseq over either).
  The forward runs
  in train mode: each BatchNorm normalizes by the batch and moves its
  running statistics in place, by flax's update, as the JAX step returns
  its mutated `batch_stats`.  `bf16=True` calls the model itself through
  `functional_call` with bf16 copies of its parameters (the BatchNorms'
  rounded to bf16 and held in f32, as flax computes BatchNorm in f32)
  and its own f32 buffers, so the statistics land in the master model;
* `make_tpn_train_step_stats`: TPNRecognizer's step, the classifier's
  cross entropy plus the neck's `loss_aux` (logged apart as `loss_cls`),
  with the same bf16 option;
* `evaluate_classification`: top-1/top-5 and mean class accuracy in eval
  mode (a BatchNorm recognizer normalizes by its running statistics).

A step runs the model in train mode: DropPath, the embedding dropouts,
the heads' dropout, the decoder's input dropout and TRNHead's tuple picks
draw from the `torch.Generator` given to the step's maker.  A
TimeSformer configured in bfloat16 trained without `bf16=True` is
refused: there the JAX package's f32 parameters promote the products of
its `Dense(dtype=None)` layers back to f32 (ROADMAP.md queue 1 item 14).
The other backbones keep f32 masters whatever their dtype says, so a
VideoMAE or CLIP configured in bfloat16 trains as the JAX one does.
Multigrid, OmniSource and mixup/cutmix blending come with item 8d.
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
from ..models.heads import TRNHead
from ..models.layers import Dropout, FlaxBatchNorm
from ..models.recognizer import (BackboneClassifier, Recognizer2D,
                                 Recognizer3D, Recognizer3DCLIP,
                                 Recognizer3DRelseq, RecognizerRelseq,
                                 TPNRecognizer)
from ..models.timesformer import DropPath
from ..utils.device import resolve_device
from ..utils.precision import no_tf32
from .optim import OptaxOptimizer

# the parts of slice 5 still to port (ROADMAP.md queue 1 item 8)
PARTS = {
    "8d": "the training recipes (mixup/cutmix blending, multigrid, "
          "OmniSource, the shuffle recognizers, the extra datasets, "
          "samplers and pipeline ops)",
    "8e": "temporal localization (BMN, BSN, SSN)",
    "8f": "spatio-temporal detection (AVA)",
    "8g": "audio recognition",
    "8h": "skeleton recognition (ST-GCN, 2s-AGCN, PoseC3D)",
    "8i": "the host tools",
}


def not_ported(what: str, part: str) -> str:
    """The refusal of what a part of slice 5 still has to port."""
    return (f"{what} is not ported yet: it comes with {PARTS[part]}, slice "
            f"5 (ROADMAP.md queue 1 item {part})")


def not_ported_model(step: str, model) -> str:
    """The refusal of a model no ported step trains."""
    return (f"{step} on {type(model).__name__} is not ported yet: it comes "
            f"with a later part of slice 5 (ROADMAP.md queue 1 item 8)")


CLASSIFIERS = (BackboneClassifier, Recognizer2D)
BF16_CONFIG = ("a TimeSformer configured with dtype='bfloat16' trains with "
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
        if isinstance(m, (DropPath, Dropout, RNNDecoderHead, TRNHead)):
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


def _refuse_blending(blending) -> None:
    if blending is not None:
        raise NotImplementedError(not_ported("blending (data/blending)",
                                             "8d"))


def has_batch_norm(model: torch.nn.Module) -> bool:
    return any(isinstance(m, FlaxBatchNorm) for m in model.modules())


def make_cls_train_step(model: Recognizer3D, blending=None,
                        bf16: bool = False,
                        generator: Optional[torch.Generator] = None,
                        device=None):
    """step(state, videos, labels) -> (state, {"loss", "top1_acc"}): one
    forward in train mode, backward and optimizer step on `device` (None:
    the CUDA device), where the model must lie.  labels: int64 class
    indices.  logs: detached 0-d tensors.  Trains a Recognizer3D, a
    Recognizer3DCLIP, or a BackboneClassifier or Recognizer2D without
    BatchNorm; the BatchNorm recognizers train with
    `make_cls_train_step_stats`."""
    _refuse_blending(blending)
    if isinstance(model, TPNRecognizer) or (
            isinstance(model, CLASSIFIERS) and has_batch_norm(model)):
        raise ValueError("a BatchNorm recognizer trains with "
                         "make_cls_train_step_stats (TPN: "
                         "make_tpn_train_step_stats)")
    if isinstance(model, CLASSIFIERS + (Recognizer3DCLIP,)):
        _check(model, device)
        no_tf32()
        set_generator(model, generator)
        return _cls_step(model,
                         _bf16_stats_forward(model) if bf16 else model)
    if not isinstance(model, Recognizer3D):
        raise NotImplementedError(not_ported_model("make_cls_train_step",
                                                   model))
    _check(model, device)
    dtype = model.backbone.cfg.dtype
    if bf16 and dtype != "float32":
        raise ValueError("bf16=True keeps float32 masters: build the model "
                         "with dtype='float32'")
    if dtype == "bfloat16":
        raise NotImplementedError(BF16_CONFIG)
    no_tf32()
    set_generator(model, generator)
    return _cls_step(model,
                     _bf16_forward(model, generator) if bf16 else model)


def _bf16_stats_forward(model: torch.nn.Module):
    """forward(videos, **kw) -> the model's outputs computed in bfloat16:
    the model called through functional_call on bf16 copies of its master
    parameters (the BatchNorms' rounded to bf16 and held in f32), its
    own f32 buffers (their running statistics move in place) and the
    videos in bf16, the casts inside autograd."""
    bn = {f"{o}.{leaf}" for o, m in model.named_modules()
          if isinstance(m, FlaxBatchNorm) for leaf in ("weight", "bias")}

    def forward(videos: torch.Tensor, **kw):
        tensors = {n: (p.to(torch.bfloat16).float() if n in bn
                       else p.to(torch.bfloat16))
                   for n, p in model.named_parameters()}
        tensors.update(model.named_buffers())
        return torch.func.functional_call(
            model, tensors, (videos.to(torch.bfloat16),), kw)

    return forward


def make_cls_train_step_stats(model: BackboneClassifier, blending=None,
                              bf16: bool = False,
                              generator: Optional[torch.Generator] = None,
                              device=None):
    """make_cls_train_step for the BatchNorm recognizers
    (BackboneClassifier, X3DClassifier, Recognizer2D): step(state, videos,
    labels) -> (state, {"loss", "top1_acc"}), the running statistics
    updated in place.  bf16: f32 masters and statistics, the forward and
    backward in bfloat16 (JAX recognition_trainer.py:122-160)."""
    _refuse_blending(blending)
    if isinstance(model, TPNRecognizer):
        raise ValueError("a TPNRecognizer trains with "
                         "make_tpn_train_step_stats")
    if not isinstance(model, CLASSIFIERS):
        raise NotImplementedError(not_ported_model(
            "make_cls_train_step_stats", model))
    _check(model, device)
    no_tf32()
    set_generator(model, generator)
    return _cls_step(model, _bf16_stats_forward(model) if bf16 else model)


def _cls_step(model: torch.nn.Module, forward):
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
    on `device` (None: the CUDA device), for a Recognizer3DRelseq or a
    RecognizerRelseq on a backbone without BatchNorm (the JAX step has no
    bf16 option).  logs: detached 0-d tensors."""
    if isinstance(model, RecognizerRelseq) and has_batch_norm(model):
        raise ValueError("a BatchNorm recognizer trains with "
                         "make_seq_train_step_stats")
    if not isinstance(model, (Recognizer3DRelseq, RecognizerRelseq)):
        raise NotImplementedError(not_ported_model("make_seq_train_step",
                                                   model))
    _check(model, device)
    if isinstance(model, Recognizer3DRelseq) \
            and model.backbone.cfg.dtype == "bfloat16":
        raise NotImplementedError(BF16_CONFIG)
    no_tf32()
    set_generator(model, generator)
    return _seq_step(model)


def make_seq_train_step_stats(model: RecognizerRelseq,
                              generator: Optional[torch.Generator] = None,
                              device=None):
    """make_seq_train_step for a RecognizerRelseq on a BatchNorm backbone
    (a per-frame one behind the temporal mean too): the running
    statistics move in place (JAX recognition_trainer.py:180-198; f32, as
    the JAX step has no bf16 option)."""
    if isinstance(model, CLASSIFIERS + (TPNRecognizer,)):
        raise ValueError("make_seq_train_step_stats trains a caption model "
                         "(RecognizerRelseq); a classifier trains with "
                         "make_cls_train_step_stats")
    if not isinstance(model, RecognizerRelseq):
        raise NotImplementedError(not_ported_model(
            "make_seq_train_step_stats", model))
    _check(model, device)
    no_tf32()
    set_generator(model, generator)
    return _seq_step(model)


def make_tpn_train_step_stats(model: TPNRecognizer, bf16: bool = False,
                              generator: Optional[torch.Generator] = None,
                              device=None):
    """step(state, videos, labels) -> (state, {"loss", "loss_cls",
    "top1_acc"}) for a TPNRecognizer (JAX recognition_trainer.py
    :515-546): the classifier's cross entropy plus the neck's
    `loss_aux` (aux_loss_weight times the aux head's cross entropy), the
    running statistics updated in place; bf16 as make_cls_train_step_
    stats has it."""
    if not isinstance(model, TPNRecognizer):
        raise ValueError(f"make_tpn_train_step_stats trains a TPNRecognizer,"
                         f" not a {type(model).__name__}")
    _check(model, device)
    no_tf32()
    set_generator(model, generator)
    forward = _bf16_stats_forward(model) if bf16 else model

    def step(state: RecTrainState, videos: torch.Tensor,
             labels: torch.Tensor):
        net, opt = state.model, state.optimizer
        if net is not model:
            raise ValueError("the state's model is not the one the step "
                             "was made for")
        net.train()
        opt.zero_grad(set_to_none=True)
        scores, aux = forward(videos, target=labels)
        scores = scores.float()
        loss_cls = F.cross_entropy(scores, labels)
        loss = loss_cls + aux.get("loss_aux", 0.0)
        acc = (scores.argmax(-1) == labels).float().mean()
        loss.backward()
        opt.step()
        return (state._replace(step=state.step + 1),
                {"loss": loss.detach(), "loss_cls": loss_cls.detach(),
                 "top1_acc": acc.detach()})

    return step


def _seq_step(model: torch.nn.Module):
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


def evaluate_classification(model: torch.nn.Module, batches) -> Dict:
    """batches: iterable of (videos, labels, n_valid) on the model's
    device.  Runs the model in eval mode without a graph (a BatchNorm
    recognizer normalizes by its running statistics); returns
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


# -- still to port ------------------------------------------------------------

def _not_ported(name: str, part: str):
    def raise_(*args, **kwargs):
        raise NotImplementedError(not_ported(name, part))
    raise_.__name__ = name
    raise_.__doc__ = f"Raises: {not_ported(name, part)}."
    return raise_


train_multigrid = _not_ported("train_multigrid", "8d")
train_omnisource = _not_ported("train_omnisource", "8d")
