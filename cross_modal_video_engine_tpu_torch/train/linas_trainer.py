"""LINAS dual-encoder training: distillation + triplet.

Counterpart of cross_modal_video_engine_tpu/train/linas_trainer.py (the
reference LINAS-engine/model.py:916-1004 `train_emb`, trainer.py:270-419),
with the same config and the same loss mix:

* de+map / map:   alpha * distill(student_cap, cap.detach())
                  [+ triplet(student_cap, vid or vid.detach())]
* text+video:     alpha * distill_text [+ video_alpha * distill_video]
                  + triplet(student) + beta * similarity_distill
* GT:             triplet(cap, vid)

A step runs the model in train mode (dropout from the trainer's
`torch.Generator`, BatchNorm's running statistics updated as flax updates
them), backpropagates, and takes one step of `train/optim.OptaxOptimizer`
(global-norm clip, then Adam or RMSprop as optax computes them).
`TrainState` is the model (parameters and BatchNorm buffers) with its
optimizer (count, moments, learning rate); a step updates both in place
and hands the state back, as the JAX step returns its new state.  The
'adapt' similarity mask (pa1 on the diagonal, pa2 off it) trains in a
second step at lr x10.  `EpochScheduler` is the host-side decay, halving
and early stop.  The JAX package's data-parallel `mesh=` path is not part
of this module (ROADMAP queue 1 item 11).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..losses.distill import (adaptive_similarity_loss, kl_distill,
                              mse_distill, similarity_distill)
from ..losses.triplet import TripletLossConfig, triplet_loss
from ..models.dual_encoding import (DualEncoding, TextBatch, VideoBatch,
                                    seeded_state_dict)
from ..models.layers import Dropout
from ..utils.device import resolve_device
from .optim import OptaxOptimizer

NO_MESH = ("the data-parallel mesh= path of the LINAS trainer is not "
           "ported yet (ROADMAP queue 1 item 11)")


@dataclasses.dataclass(frozen=True)
class LinasTrainConfig:
    learning_rate: float = 1e-4
    lr_decay_rate: float = 0.99
    grad_clip: float = 2.0
    optimizer: str = "adam"           # | 'rmsprop'
    # loss mix (reference trainer defaults)
    loss_fun: str = "mrl"
    margin: float = 0.2
    direction: str = "all"
    max_violation: bool = False
    cost_style: str = "sum"
    measure: str = "cosine"
    alpha: float = 0.2
    beta: float = 1.0
    video_alpha: float = 1.0
    distill_type: str = "mse"         # 'mse' | 'kl' | 'mse+kl' | 'cross'
    distill_loss: str = "text"        # 'text' | 'video' | 'text+video'
    distill_with_triplet: bool = True
    distill_with_similarity: bool = False
    similarity_type: Optional[str] = None
    with_detach: bool = True
    finetune_vid: bool = False
    # schedule
    num_epochs: int = 50
    lr_halve_patience: int = 3
    early_stop_patience: int = 6


class TrainState(NamedTuple):
    model: DualEncoding              # parameters and BatchNorm buffers
    optimizer: OptaxOptimizer        # count, moments, learning rate


def make_optimizer(cfg: LinasTrainConfig
                   ) -> Callable[..., OptaxOptimizer]:
    """The optimizer's factory: called on (name, parameter) pairs."""
    return functools.partial(OptaxOptimizer, lr=cfg.learning_rate,
                             kind=cfg.optimizer, max_norm=cfg.grad_clip)


def _distill(cfg: LinasTrainConfig, student, teacher):
    red = cfg.cost_style  # 'sum' | 'mean' like the torch size_average flag
    if cfg.distill_type == "mse":
        return mse_distill(student, teacher, red)
    if cfg.distill_type == "kl":
        return kl_distill(student, teacher, red)
    if cfg.distill_type == "mse+kl":
        return (mse_distill(student, teacher, red)
                + kl_distill(student, teacher, red))
    # 'cross' spans both towers and is handled at the call site
    # (MSE on text + KL on video, model.py:926-927)
    raise ValueError(f"per-tensor distill got type {cfg.distill_type!r}")


def linas_loss(out: Dict[str, torch.Tensor], style: str,
               student_model: str, cfg: LinasTrainConfig,
               adapt_mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, logs) of one forward's embeddings: the loss mix of the JAX
    package's loss_fn (linas_trainer.py:109-185)."""
    tl_cfg = TripletLossConfig(cfg.margin, cfg.measure, cfg.max_violation,
                               cfg.cost_style, cfg.direction)
    logs = {}
    if style == "GT":
        loss = triplet_loss(out["cap_emb"], out["vid_emb"], tl_cfg)
        logs["triplet"] = loss
    elif student_model == "text+video":
        cap_t = out["cap_emb"].detach()
        vid_t = out["vid_emb"].detach()
        if cfg.distill_loss == "text+video":
            if cfg.distill_type == "cross":
                # 'cross' = MSE on the text tower + KL on the video tower,
                # unweighted (model.py:926-927)
                loss1 = (mse_distill(out["student_cap_emb"], cap_t,
                                     cfg.cost_style)
                         + kl_distill(out["student_vid_emb"], vid_t,
                                      cfg.cost_style))
            else:
                loss1 = (_distill(cfg, out["student_cap_emb"], cap_t)
                         + cfg.video_alpha *
                         _distill(cfg, out["student_vid_emb"], vid_t))
        elif cfg.distill_loss == "video":
            loss1 = _distill(cfg, out["student_vid_emb"], vid_t)
        else:
            loss1 = _distill(cfg, out["student_cap_emb"], cap_t)
        loss = cfg.alpha * loss1
        logs["distill"] = loss1
        if cfg.distill_with_triplet:
            loss2 = triplet_loss(out["student_cap_emb"],
                                 out["student_vid_emb"], tl_cfg)
            loss = loss + loss2
            logs["triplet"] = loss2
        if cfg.distill_with_similarity:
            # 'adapt': the learned mask weights the huber terms but is
            # itself detached here (model.py:862-866); it trains in the
            # separate lr x10 step (make_mask_train_step)
            loss3 = similarity_distill(
                vid_t, cap_t, out["student_vid_emb"],
                out["student_cap_emb"], cfg.similarity_type,
                adapt_weight=(None if adapt_mask is None
                              else adapt_mask.detach()),
                reduction=cfg.cost_style)
            loss = loss + cfg.beta * loss3
            logs["similarity"] = loss3
    else:  # 'map' / 'de+map'
        cap_t = out["cap_emb"].detach() if cfg.with_detach \
            else out["cap_emb"]
        loss2 = _distill(cfg, out["student_cap_emb"], cap_t)
        loss = cfg.alpha * loss2
        logs["distill"] = loss2
        if cfg.distill_with_triplet:
            vid = (out["vid_emb"].detach()
                   if cfg.with_detach and not cfg.finetune_vid
                   else out["vid_emb"])
            loss3 = triplet_loss(out["student_cap_emb"], vid, tl_cfg)
            loss = loss + loss3
            logs["triplet"] = loss3
    logs["loss"] = loss
    return loss, logs


def set_dropout_generator(model: torch.nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Every dropout of the model draws from `generator`."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def _check_device(model: DualEncoding, device) -> None:
    dev = resolve_device(device)
    if model.device.type != dev.type or (
            dev.index is not None and model.device.index != dev.index):
        raise ValueError(f"the model is on {model.device}, the step was "
                         f"asked to run on {dev} (device=None means the "
                         f"CUDA device; pass device='cpu' for the CPU)")


def _check_model(state: TrainState, model: DualEncoding) -> None:
    if state.model is not model:
        raise ValueError("the state's model is not the one the step was "
                         "made for")


def make_train_step(model: DualEncoding, cfg: LinasTrainConfig,
                    generator: Optional[torch.Generator] = None,
                    mesh=None, device=None):
    """step(state, videos, text, support, adapt_mask=None) -> (state,
    logs): one forward in train mode, backward and optimizer step, on
    `device` (None: the CUDA device), where the model must lie.  Dropout
    draws from `generator`.  logs: detached 0-d tensors."""
    if mesh is not None:
        raise NotImplementedError(NO_MESH)
    _check_device(model, device)
    set_dropout_generator(model, generator)
    mcfg = model.cfg

    def step(state: TrainState, videos: VideoBatch, text: TextBatch,
             support: Optional[TextBatch], adapt_mask=None):
        net, opt = state
        _check_model(state, model)
        net.train()
        opt.zero_grad(set_to_none=True)
        # with_detach also detaches the teacher FEATURE inside the forward
        # (model.py:685-687), so the student path cannot backprop into the
        # teacher text encoder
        out = net(videos, text, support,
                  detach_teacher_feature=cfg.with_detach)
        loss, logs = linas_loss(out, mcfg.style, mcfg.student_model, cfg,
                                adapt_mask)
        loss.backward()
        opt.step()
        return state, {k: v.detach() for k, v in logs.items()}

    return step


# ---------------------------------------------------------------------------
# 'adapt' similarity mask: pa1*I + pa2*(1-I) trained at lr x10
# (model.py:584-598 second optimizer, :896-912 train_mask)
# ---------------------------------------------------------------------------

class MaskState(NamedTuple):
    pa: torch.Tensor                 # (2,) = [pa1 (diagonal), pa2 (off)]
    optimizer: OptaxOptimizer


def mask_matrix(pa: torch.Tensor, batch_size: int) -> torch.Tensor:
    eye = torch.eye(batch_size, dtype=pa.dtype, device=pa.device)
    return pa[0] * eye + pa[1] * (1.0 - eye)


def make_mask_optimizer(cfg: LinasTrainConfig
                        ) -> Callable[..., OptaxOptimizer]:
    """Adam at 10x the model LR over (pa1, pa2): the reference optimizer2,
    a plain optax chain (no injected learning rate)."""
    return functools.partial(OptaxOptimizer, lr=10.0 * cfg.learning_rate,
                             kind="adam", max_norm=cfg.grad_clip)


def init_mask_state(tx2, device=None) -> MaskState:
    """pa = (1, 1), the reference init, on `device` (None: CUDA)."""
    pa = torch.ones(2, dtype=torch.float32, device=resolve_device(device),
                    requires_grad=True)
    return MaskState(pa, tx2([("pa", pa)]))


def make_mask_train_step(model: DualEncoding):
    """train_mask(mask_state, state, videos, text, support) -> (mask_state,
    loss): the embeddings of an eval-mode forward without gradient (the
    reference runs forward_emb under no_grad), then the adaptive
    similarity loss backpropagates into (pa1, pa2) only.  The mask's
    optimizer lives in the MaskState (the JAX function also takes it)."""

    def train_mask(mask_state: MaskState, state: TrainState, videos, text,
                   support):
        _check_model(state, model)
        model.eval()
        with torch.no_grad():
            out = model(videos, text, support)
        embs = (out["vid_emb"], out["cap_emb"], out["student_vid_emb"],
                out["student_cap_emb"])
        opt = mask_state.optimizer
        opt.zero_grad(set_to_none=True)
        loss = adaptive_similarity_loss(
            *embs, mask_matrix(mask_state.pa, embs[0].shape[0]))
        loss.backward()
        opt.step()
        return mask_state, float(loss.detach())

    return train_mask


def init_train_state(model: DualEncoding, tx, seed: int = 0) -> TrainState:
    """The model's weights drawn by `seeded_state_dict(model.cfg, seed)`
    (a numpy seed; the JAX package draws flax's init), and a fresh
    optimizer over its parameters."""
    sd = seeded_state_dict(model.cfg, seed)
    model.load_state_dict(sd)
    return TrainState(model, tx(list(model.named_parameters())))


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    state.optimizer.lr = lr
    return state


def get_learning_rate(state: TrainState) -> float:
    return state.optimizer.lr


class EpochScheduler:
    """Host-side LR decay + early stop (trainer.py:298-315)."""

    def __init__(self, cfg: LinasTrainConfig):
        self.cfg = cfg
        self.best = -np.inf
        self.no_impr = 0
        self.since_halve = 0      # reference lr_counter: epochs since
                                  # the LAST halve, not consecutive bads

    def on_epoch_end(self, state: TrainState, score: float
                     ) -> Tuple[TrainState, bool, bool]:
        """Returns (state, is_best, should_stop).  Reference semantics
        (trainer.py:298-307): halve on ANY non-improving epoch, but use
        each learning rate for at least `lr_halve_patience` epochs."""
        lr = get_learning_rate(state) * self.cfg.lr_decay_rate
        self.since_halve += 1
        is_best = score > self.best
        if is_best:
            self.best = score
            self.no_impr = 0
        else:
            self.no_impr += 1
            if self.since_halve >= self.cfg.lr_halve_patience:
                lr *= 0.5
                self.since_halve = 0
        state = set_learning_rate(state, lr)
        stop = self.no_impr >= self.cfg.early_stop_patience
        return state, is_best, stop
