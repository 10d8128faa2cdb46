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
  with top-1 accuracy, for a Recognizer3D (a TimeSformer) and the
  recognizers without BatchNorm (`BackboneClassifier` over Swin3D, MViT,
  VideoMAEViT or VideoCLIP's pooled encoder, and `Recognizer3DCLIP`).
  Their parameters are f32 masters whatever their config's dtype says,
  and each layer computes in the dtype flax gives it (models/flax_nn.py;
  a TimeSformer configured in bfloat16 rounds its input and embeddings
  to bf16 and computes in f32 from there, as the JAX one does).
  `bf16=True` calls the model itself through `torch.func.functional_call`
  on bfloat16 copies of the masters and the videos, the casts inside
  autograd, the scores in f32, the gradients back in f32: the JAX step's
  `_cast_tree` (mmcv's Fp16OptimizerHook);
* `blending=` (data/blending.py, mixup or cutmix) in both classification
  steps: the blend runs after the bf16 cast of the videos and before the
  dropout draws, the loss is the soft-label cross entropy and the
  accuracy is taken against the hard labels (JAX :91-105, 127-145);
* `make_seq_train_step`: the SeqMLL loss with teacher forcing
  (`Recognizer3DRelseq.forward_train`, or a `RecognizerRelseq` on a
  backbone without BatchNorm);
* `make_cls_train_step_stats` and `make_seq_train_step_stats`: the same
  for the BatchNorm recognizers (BackboneClassifier and X3DClassifier
  over models/resnet3d.py's and backbones2d.py's pooled backbones,
  Recognizer2D over the per-frame ones, RecognizerRelseq over either,
  SkeletonClassifier over models/stgcn.py's graph backbones).
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
  mode (a BatchNorm recognizer normalizes by its running statistics);
* multigrid (JAX :203-400): `adapt_clips_to_bucket` (frames picked by
  np.round(np.linspace), the antialiased bilinear resize of
  `jax.image.resize`: ops/preprocess.resize), `bucketize_batches` and
  `_RawChunker` (tails dropped), `make_multigrid_train_step` (the
  optimizer's whole update, weight decay included, times the bucket's
  `lr_scale`, the schedule's count one a step whatever the bucket) and
  `train_multigrid` (the long cycle epoch by epoch, the short cycle step
  by step, precise BN at the finest bucket after training);
* OmniSource (JAX :403-492): `train_omnisource` alternates the main
  source with waves of the auxiliary ones every `train_ratio[0]` main
  steps (`it` counted across epochs from `init_it`), an exhausted aux
  source rebuilt and an empty one ending its wave (`_cycle`), the logs
  of aux batches under `/auxN` keys, `epoch_callback` after each epoch.

A step runs the model in train mode: DropPath, the embedding dropouts,
the heads' dropout, the decoder's input dropout and TRNHead's tuple picks
draw from the `torch.Generator` given to the step's maker (the loops:
to `train_multigrid` and `train_omnisource`, reseeded each epoch from
`dropout_seed` when it is given).  A model whose parameters are not f32
masters (one cast whole to bf16 for serving) is refused.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import (Any, Callable, Dict, Iterable, List, NamedTuple,
                    Optional, Sequence)

import numpy as np
import torch
import torch.nn.functional as F

from ..metrics.accuracy import mean_class_accuracy, top_k_accuracy
from ..models.decoder_head import RNNDecoderHead
from ..models.heads import TRNHead
from ..models.layers import Dropout, FlaxBatchNorm
from ..models.stgcn import SkeletonClassifier
from ..models.recognizer import (BackboneClassifier, Recognizer2D,
                                 Recognizer3D, Recognizer3DCLIP,
                                 Recognizer3DRelseq, RecognizerRelseq,
                                 TPNRecognizer)
from ..models.timesformer import DropPath
from ..ops.preprocess import resize
from ..utils.device import resolve_device
from ..utils.precision import no_tf32
from .optim import OptaxOptimizer

# the parts of slice 5 still to port (ROADMAP.md queue 1 item 8)
PARTS = {
    "8g": "audio recognition",
}


def not_ported(what: str, part: str) -> str:
    """The refusal of what a part of slice 5 still has to port."""
    return (f"{what} is not ported yet: it comes with {PARTS[part]}, slice "
            f"5 (ROADMAP.md queue 1 item {part})")


def not_ported_model(step: str, model) -> str:
    """The refusal of a model no ported step trains."""
    return (f"{step} on {type(model).__name__} is not ported yet: it comes "
            f"with a later part of slice 5 (ROADMAP.md queue 1 item 8)")


CLASSIFIERS = (BackboneClassifier, Recognizer2D, SkeletonClassifier)


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


def _check_masters(model: torch.nn.Module) -> None:
    """Training keeps f32 masters: a model cast whole to bf16 (a serving
    loader's cast) is refused."""
    bad = next(((n, p.dtype) for n, p in model.named_parameters()
                if p.dtype != torch.float32), None)
    if bad is not None:
        raise ValueError(f"training keeps float32 masters; {bad[0]} is "
                         f"{bad[1]} (bf16=True runs the step on a bf16 "
                         f"copy)")


def has_batch_norm(model: torch.nn.Module) -> bool:
    return any(isinstance(m, FlaxBatchNorm) for m in model.modules())


def _prepare(model: torch.nn.Module, generator, device) -> None:
    _check(model, device)
    _check_masters(model)
    no_tf32()
    set_generator(model, generator)


def make_cls_train_step(model: Recognizer3D, blending=None,
                        bf16: bool = False,
                        generator: Optional[torch.Generator] = None,
                        device=None):
    """step(state, videos, labels, draws=None) -> (state, {"loss",
    "top1_acc"}): one forward in train mode, backward and optimizer step
    on `device` (None: the CUDA device), where the model must lie.
    labels: int64 class indices; draws: the blending's draws handed in
    (None: it draws them).  logs: detached 0-d tensors.  Trains a
    Recognizer3D, a Recognizer3DCLIP, or a BackboneClassifier or
    Recognizer2D without BatchNorm; the BatchNorm recognizers train with
    `make_cls_train_step_stats`."""
    if isinstance(model, TPNRecognizer) or (
            isinstance(model, CLASSIFIERS) and has_batch_norm(model)):
        raise ValueError("a BatchNorm recognizer trains with "
                         "make_cls_train_step_stats (TPN: "
                         "make_tpn_train_step_stats)")
    if not isinstance(model, CLASSIFIERS + (Recognizer3DCLIP, Recognizer3D)):
        raise NotImplementedError(not_ported_model("make_cls_train_step",
                                                   model))
    _prepare(model, generator, device)
    return _cls_step(model, _bf16_forward(model) if bf16 else model,
                     blending, bf16)


def _bf16_forward(model: torch.nn.Module):
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
    (BackboneClassifier, X3DClassifier, Recognizer2D, SkeletonClassifier):
    step(state, videos, labels, draws=None) -> (state, {"loss",
    "top1_acc"}), the running
    statistics updated in place.  bf16: f32 masters and statistics, the
    forward and backward in bfloat16 (JAX recognition_trainer.py
    :122-160)."""
    if isinstance(model, TPNRecognizer):
        raise ValueError("a TPNRecognizer trains with "
                         "make_tpn_train_step_stats")
    if not isinstance(model, CLASSIFIERS):
        raise NotImplementedError(not_ported_model(
            "make_cls_train_step_stats", model))
    _prepare(model, generator, device)
    return _cls_step(model, _bf16_forward(model) if bf16 else model,
                     blending, bf16)


def _cls_step(model: torch.nn.Module, forward, blending=None,
              bf16: bool = False, update_scale: Optional[float] = None):
    """The classification step: the videos cast to bf16 under bf16, then
    blended (soft-label cross entropy, top-1 against the hard labels),
    then the forward; the optimizer's update times update_scale."""
    def step(state: RecTrainState, videos: torch.Tensor,
             labels: torch.Tensor, draws: Optional[Dict] = None):
        net, opt = state.model, state.optimizer
        if net is not model:
            raise ValueError("the state's model is not the one the step "
                             "was made for")
        net.train()
        opt.zero_grad(set_to_none=True)
        if bf16:
            videos = videos.to(torch.bfloat16)
        soft = None
        if blending is not None:
            videos, soft = blending(videos, labels, draws)
        scores = forward(videos).float()
        if soft is None:
            loss = F.cross_entropy(scores, labels)
        else:
            loss = -(soft * torch.log_softmax(scores, -1)).sum(-1).mean()
        acc = (scores.argmax(-1) == labels).float().mean()
        loss.backward()
        opt.step(update_scale=update_scale)
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
    _prepare(model, generator, device)
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
    _prepare(model, generator, device)
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
    _prepare(model, generator, device)
    forward = _bf16_forward(model) if bf16 else model

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


# -- multigrid (train/multigrid.py's schedule) ----------------------------------

def adapt_clips_to_bucket(clips: torch.Tensor, bucket) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, bucket.num_frames, res, res, C): frames
    picked at np.round(np.linspace(0, T - 1, frames)), then the
    antialiased bilinear resize of jax.image.resize(..., "linear")."""
    b, t, h, w, c = clips.shape
    if t != bucket.num_frames:
        idx = np.round(np.linspace(0, t - 1, bucket.num_frames)).astype(int)
        clips = clips[:, torch.from_numpy(idx).to(clips.device)]
    r = bucket.resolution
    if (h, w) != (r, r):
        clips = resize(clips.float(), (r, r), "bilinear")
    return clips


def bucketize_batches(batches, bucket):
    """(clips, labels) batches regrouped into the bucket's shape: clips
    adapted, re-chunked to bucket.batch_size, the tail dropped."""
    buf_c: List[torch.Tensor] = []
    buf_l: List[torch.Tensor] = []
    for clips, labels in batches:
        buf_c.append(adapt_clips_to_bucket(clips, bucket))
        buf_l.append(torch.as_tensor(labels))
        have = sum(x.shape[0] for x in buf_c)
        while have >= bucket.batch_size:
            cat_c, cat_l = torch.cat(buf_c), torch.cat(buf_l)
            yield cat_c[:bucket.batch_size], cat_l[:bucket.batch_size]
            buf_c, buf_l = [cat_c[bucket.batch_size:]], \
                [cat_l[bucket.batch_size:]]
            have = buf_c[0].shape[0]


class _RawChunker:
    """Chunks of exactly n samples from a stream of full-shape (clips,
    labels) batches, the tail dropped: the short cycle's steps draw
    different batch sizes one after another."""

    def __init__(self, batches):
        self._it = iter(batches)
        self._c: List[torch.Tensor] = []
        self._l: List[torch.Tensor] = []
        self._have = 0

    def take(self, n: int):
        while self._have < n:
            try:
                c, lab = next(self._it)
            except StopIteration:
                return None
            self._c.append(c)
            self._l.append(torch.as_tensor(lab))
            self._have += c.shape[0]
        cat_c, cat_l = torch.cat(self._c), torch.cat(self._l)
        self._c, self._l = [cat_c[n:]], [cat_l[n:]]
        self._have = cat_c.shape[0] - n
        return cat_c[:n], cat_l[:n]


def make_multigrid_train_step(model: torch.nn.Module, lr_scale: float,
                              generator: Optional[torch.Generator] = None,
                              device=None):
    """step(state, videos, labels) -> (state, {"loss", "top1_acc"}): the
    classification step in f32 (a BatchNorm recognizer's statistics
    moving in place) with the optimizer's update times lr_scale (JAX
    recognition_trainer.py:166-196)."""
    if isinstance(model, TPNRecognizer):
        raise ValueError("a TPNRecognizer trains with "
                         "make_tpn_train_step_stats")
    _prepare(model, generator, device)
    return _cls_step(model, model, update_scale=lr_scale)


def _mean(xs: Sequence[torch.Tensor]) -> float:
    if not xs:
        return float("nan")
    return float(torch.stack(list(xs)).double().mean())


def _reseed(generator: Optional[torch.Generator], seed: Optional[int],
            epoch: int) -> None:
    if generator is not None and seed is not None:
        generator.manual_seed(seed + epoch)


def train_multigrid(model: torch.nn.Module, tcfg: RecognitionTrainConfig,
                    schedule, epoch_batches: Callable[[int], Any],
                    total_epochs: int,
                    generator: Optional[torch.Generator] = None,
                    precise_bn_batches: int = 0,
                    total_steps: Optional[int] = None, device=None,
                    dropout_seed: Optional[int] = None):
    """The multigrid loop (JAX recognition_trainer.py:203-400): each epoch
    at the schedule's bucket (with a short cycle, each step at its own),
    the update scaled by bucket.batch_size / schedule.base_batch.
    epoch_batches(epoch) yields full-shape (clips, labels); adapting and
    re-chunking happen here.  precise_bn_batches > 0 recomputes a
    BatchNorm recognizer's running statistics at the finest bucket from
    epoch_batches(total_epochs) after training.  Returns (the final
    RecTrainState, history): one row an epoch with its bucket, lr_scale,
    mean loss and top-1 and its step count."""
    tx = (make_rec_optimizer(tcfg, total_steps=total_steps)
          if total_steps else make_rec_optimizer(tcfg))
    state = init_rec_state(model, tx)
    steps: Dict[Any, Callable] = {}

    def get_step(bucket):
        if bucket not in steps:
            steps[bucket] = make_multigrid_train_step(
                model, bucket.batch_size / schedule.base_batch, generator,
                device)
        return steps[bucket]

    history = []
    for epoch in range(total_epochs):
        _reseed(generator, dropout_seed, epoch)
        bucket = schedule.bucket_for(epoch, total_epochs)
        losses, accs = [], []
        if schedule.short_cycle_period:
            chunker = _RawChunker(epoch_batches(epoch))
            while True:
                b_step = schedule.bucket_for(epoch, total_epochs,
                                             len(losses))
                chunk = chunker.take(b_step.batch_size)
                if chunk is None:
                    break
                state, logs = get_step(b_step)(
                    state, adapt_clips_to_bucket(chunk[0], b_step),
                    chunk[1])
                losses.append(logs["loss"])
                accs.append(logs["top1_acc"])
        else:
            step = get_step(bucket)
            for clips, labels in bucketize_batches(epoch_batches(epoch),
                                                   bucket):
                state, logs = step(state, clips, labels)
                losses.append(logs["loss"])
                accs.append(logs["top1_acc"])
        history.append({
            "epoch": epoch, "bucket": (bucket.batch_size, bucket.num_frames,
                                       bucket.resolution),
            "lr_scale": bucket.batch_size / schedule.base_batch,
            "loss": _mean(losses), "top1_acc": _mean(accs),
            "steps": len(losses)})
    if has_batch_norm(model) and precise_bn_batches > 0:
        from .precise_bn import update_bn_stats
        update_bn_stats(
            model, bucketize_batches(epoch_batches(total_epochs),
                                     schedule.buckets[-1]),
            num_iters=precise_bn_batches,
            forward=lambda m, batch: m(batch[0]))
    return state, history


# -- OmniSource (MCT core/runner/omnisource_runner.py:42-100) -------------------

def _cycle(make_iter):
    """Batches of make_iter(), rebuilt each time they run out; ends when a
    fresh one is empty."""
    while True:
        empty = True
        for x in make_iter():
            empty = False
            yield x
        if empty:
            return


def train_omnisource(model: torch.nn.Module, tcfg: RecognitionTrainConfig,
                     main_batches: Callable[[int], Any],
                     aux_batches: Sequence[Callable[[], Any]],
                     train_ratio: Sequence[int], total_epochs: int,
                     generator: Optional[torch.Generator] = None,
                     total_steps: Optional[int] = None,
                     start_epoch: int = 0,
                     state: Optional[RecTrainState] = None,
                     init_it: int = 0, epoch_callback=None, device=None,
                     dropout_seed: Optional[int] = None):
    """The main source drives the epoch; after every main step whose
    count `it` (across epochs, from init_it) is a multiple of
    train_ratio[0], train_ratio[1 + i] batches of aux source i step the
    same model and optimizer.  main_batches(epoch) and each
    aux_batches[i]() yield (clips, labels); the logs of aux source i are
    averaged under "<key>/aux<i>".  state: the state to resume from (None:
    a new one over the model).  epoch_callback(epoch, {"state", "it"})
    runs after each epoch.  Returns (the final RecTrainState, history)."""
    tx = (make_rec_optimizer(tcfg, total_steps=total_steps)
          if total_steps else make_rec_optimizer(tcfg))
    step_fn = make_multigrid_train_step(model, 1.0, generator, device)
    if state is None:
        state = init_rec_state(model, tx)
    every, aux_times = train_ratio[0], list(train_ratio[1:])
    if len(aux_times) != len(aux_batches):
        raise ValueError(f"train_ratio {list(train_ratio)} names "
                         f"{len(aux_times)} aux sources, given "
                         f"{len(aux_batches)}")
    aux_iters = [_cycle(fn) for fn in aux_batches]
    history = []
    it = init_it
    for epoch in range(start_epoch, total_epochs):
        _reseed(generator, dropout_seed, epoch)
        logs_sum: Dict[str, List[torch.Tensor]] = {}

        def record(logs, source):
            for k, v in logs.items():
                logs_sum.setdefault(k + source, []).append(v)

        for clips, labels in main_batches(epoch):
            state, logs = step_fn(state, clips, labels)
            record(logs, "")
            if it % every == 0:
                for idx, n_times in enumerate(aux_times):
                    for _ in range(n_times):
                        try:
                            aclips, alabels = next(aux_iters[idx])
                        except StopIteration:
                            break
                        state, logs = step_fn(state, aclips, alabels)
                        record(logs, f"/aux{idx}")
            it += 1
        history.append({"epoch": epoch, **{k: _mean(v)
                                           for k, v in logs_sum.items()}})
        if epoch_callback is not None:
            epoch_callback(epoch, {"state": state, "it": it})
    return state, history
