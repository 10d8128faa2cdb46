"""Config-driven recognition training CLI: TimeSformer, the CNNs and the
transformer and CLIP backbones.

Counterpart of cross_modal_video_engine_tpu/cli/recognition_train.py (MCT
tools/train.py) for `model.backbone.type='TimeSformer'` (a Recognizer3D),
for the pooled CNN families ResNet3D/SlowOnly, CSN, SlowFast, X3D, C3D
and R2Plus1D (a BackboneClassifier), for the per-frame families TSM, TSN
(TSM without the shift), TIN, TINExact, TANet and MobileNetV2TSM (a
Recognizer2D with a TSNHead, or a TRNHead when `model.head` is
`dict(type='TRNHead', ...)`) and for `model.neck=dict(type='TPN', ...)`
over a ResNet3D (a TPNRecognizer, its aux head's classes defaulting to
`num_classes`), their BatchNorms trained by `make_cls_train_step_stats`
or `make_tpn_train_step_stats`, for the transformer backbones Swin3D,
MViT and VideoMAEViT and for VideoCLIP's pooled video encoder
(`VideoCLIPPooled`; a BackboneClassifier, trained by
`make_cls_train_step`), and for 'CLIP' (a Recognizer3DCLIP over the
config's CLIPConfig, its fused_attn/fused_mlp flags included), trained
with cross entropy, on the card unless `--device cpu`.

  python -m cross_modal_video_engine_tpu_torch.cli.recognition_train \\
      CONFIG --work_dir WORK [--resume [EPOCH_DIR]] [--total_epochs N] \\
      [--cfg-options optimizer.bf16=True \\
       model.backbone.attention_type=joint_space_time \\
       model.backbone.use_flash_attention=True] [--device cpu]

Config (configs/recognition/timesformer_divst_8x32_k400.py,
slowfast_r50_4x16_k400.py, tsm_r50_1x1x8_k400.py, tpn_slowonly_r50_8x8_
k400.py, ...): `model` (backbone, num_classes), `data`
(train/val `filename label` splits, pipeline, videos_per_gpu),
`optimizer` (train/recognition_trainer.RecognitionTrainConfig: sgd or
adamw, clip, warmup, `bf16`), `total_epochs`, `eval_interval`.

The epoch loop is the JAX CLI's: train on `ShardedSampler`'s order, every
`eval_interval` epochs top-k and mean class accuracy on the val split
(the CNNs over their running statistics), `model_best` kept by
`top1_acc` with the {backbone, num_classes} config and, for the CNNs with
BatchNorms, the `batch_stats`; `epoch_{n}` each epoch's train state in the JAX
package's layout, `{"state", "batch_stats"}` (`--resume` with no
directory takes the newest).  With `optimizer.bf16=True` the masters
(and statistics) stay f32 and the step runs in bfloat16.  The weights
start from `models.recognizer.init_state_dict` or `conv_init_state_dict`
(numpy seed 0); the dropouts draw from a generator seeded anew each
epoch (seed 1 + epoch).  `train_from_config(..., reader=)` hands the
pipeline a decord-alike reader.  `build_backbone` and
`build_caption_backbone` (with `_TemporalMean` for per-frame backbones)
are shared with cli/caption_train and `api.init_recognizer`.

Three recipes, as the JAX CLI has them:

* `train_cfg.blending=dict(type='MixupBlending' | 'CutmixBlending',
  alpha=...)`: the classification steps blend each batch
  (data/blending.py; the blend's numpy generator seeded anew each epoch,
  seed 1 + epoch; TPN's step takes none, as in JAX);
* `omnisource=dict(train_ratio=[main, aux0, ...], aux=[dict(ann_file,
  data_prefix[, pipeline]), ...])`: `train_omnisource` over the main
  split and the aux splits (their batches unshuffled), the schedule's
  steps counting the aux waves (`_omnisource_total_steps`), each epoch's
  `{"params", "batch_stats", "opt_state"}` with `{"epoch", "it"}` in
  `epoch_{n}` (`--resume` continues from them), then the val report and
  `omnisource_final`;
* `multigrid=dict(buckets=[[batch, frames, res], ...], ...)`
  (train/multigrid.MultigridSchedule): `train_multigrid`, its schedule's
  steps counted at the config's batch size as the JAX CLI counts them,
  then `multigrid_final`.

The port's TIN and TANet configs carry the
clip length (`num_segments`, default 8) that the JAX modules read off
their input.  As the JAX CLI does, the model is built after the first
training batch is read: a Swin3D's relative-position tables are sized by
the windows that batch's shape clips (`input_shape`).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..config import Config
from ..convert.from_jax import (conv_recognizer_variables_to_jax,
                                recognizer_variables_to_jax)
from ..data.datasets import ShardedSampler, VideoDataset
from ..data.pipelines import build_pipeline, with_reader
from ..models import (backbones2d, mvit, resnet3d, swin3d, tanet,
                      tin_mobilenet, videomae_vit)
from ..models.clip import CLIPConfig
from ..models.recognizer import (BackboneClassifier, Recognizer2D,
                                 Recognizer3D, Recognizer3DCLIP,
                                 TPNRecognizer, conv_init_state_dict,
                                 init_state_dict)
from ..models.timesformer import TimeSformerConfig
from ..models.tpn import TPNConfig
from ..models.videoclip import VideoCLIPConfig, VideoCLIPPooled
from ..train.checkpoint import best_checkpoint_manager
from ..train.checkpoint import save_checkpoint
from ..train.recognition_trainer import (
    RecognitionTrainConfig, RecTrainState, evaluate_classification,
    has_batch_norm, init_rec_state, make_cls_train_step,
    make_cls_train_step_stats, make_rec_optimizer, make_tpn_train_step_stats,
    train_multigrid, train_omnisource)
from ..train.resume import (latest_checkpoint, load_train_state,
                            save_train_state)
from ..utils.device import resolve_device
from ..utils.precision import no_tf32
from .caption_train import DROPOUT_SEED, INIT_SEED, steps_per_epoch


def _deep_tuple(v):
    if isinstance(v, list):
        return tuple(_deep_tuple(x) for x in v)
    return v


# backbones with per-frame (B, T, C) features (Recognizer2D's)
PER_FRAME_BACKBONES = ("TANet", "TSM", "TSN", "TIN", "TINExact",
                       "MobileNetV2TSM")
# model.backbone.type -> (module, class, config class)
CNN_BACKBONES = {
    "ResNet3D": (resnet3d, "ResNet3D", "ResNet3DConfig"),
    "SlowOnly": (resnet3d, "ResNet3D", "ResNet3DConfig"),
    "SlowFast": (resnet3d, "SlowFast", "SlowFastConfig"),
    "X3D": (resnet3d, "X3D", "X3DConfig"),
    "CSN": (resnet3d, "CSN", "CSNConfig"),
    "TSM": (backbones2d, "TSMResNet", "TSMConfig"),
    "TSN": (backbones2d, "TSMResNet", "TSMConfig"),
    "R2Plus1D": (backbones2d, "R2Plus1D", "R2Plus1DConfig"),
    "C3D": (backbones2d, "C3D", None),
    "TIN": (tin_mobilenet, "TINResNet", "TINConfig"),
    "TINExact": (tin_mobilenet, "TINResNetExact", "TINExactConfig"),
    "MobileNetV2TSM": (tin_mobilenet, "MobileNetV2TSM",
                       "MobileNetV2TSMConfig"),
    "TANet": (tanet, "TANet", "TANetConfig"),
    "MViT": (mvit, "MViT", "MViTConfig"),
    "VideoMAEViT": (videomae_vit, "VideoMAEViT", "VideoMAEConfig"),
}


def build_backbone(btype: str, kw: dict, device=None,
                   input_shape=None, in_channels: int = 3) -> nn.Module:
    """The backbone `model.backbone.type` names (shared by the recognition
    and caption trainers and `api.init_recognizer`): the CNN families of
    models/{resnet3d,backbones2d,tin_mobilenet,tanet}.py ('SlowOnly' is a
    ResNet3D, 'TSN' a TSM with shift_div=0) and the transformers Swin3D
    (its tables sized for videos of `input_shape` (T, H, W)), MViT and
    VideoMAEViT.  'CLIP' and 'VideoCLIP' are recognizers, not backbones,
    here as in the JAX CLI: they raise "unknown backbone type".
    in_channels: a ResNet3D's stem input channels (a PoseC3D's
    heatmaps)."""
    if btype == "Swin3D":
        return swin3d.Swin3D(swin3d.Swin3DConfig(**kw), device, input_shape)
    if btype in CNN_BACKBONES:
        module, cls, cfg_cls = CNN_BACKBONES[btype]
        if btype == "TSN":
            kw = dict(kw, shift_div=0)
        if cfg_cls is None:                          # C3D takes keywords
            return getattr(module, cls)(**kw, device=device)
        cfg = getattr(module, cfg_cls)(**kw)
        if cls == "ResNet3D":
            return module.ResNet3D(cfg, device, in_channels=in_channels)
        return getattr(module, cls)(cfg, device)
    raise ValueError(f"unknown backbone type {btype}")


class _TemporalMean(nn.Module):
    """A per-frame (B, T, C) backbone pooled to (B, C) over time; its
    parameters under `inner`, as the JAX module's."""

    def __init__(self, inner: nn.Module):
        super().__init__()
        self.inner = inner
        self.feat_dim = inner.feat_dim

    def forward(self, videos: torch.Tensor) -> torch.Tensor:
        return self.inner(videos).mean(1)


def build_caption_backbone(btype: str, kw: dict, device=None,
                           input_shape=None, in_channels: int = 3
                           ) -> nn.Module:
    """The caption trainer's backbone: a pooled (B, C) feature, per-frame
    backbones behind `_TemporalMean`."""
    backbone = build_backbone(btype, kw, device, input_shape, in_channels)
    if btype in PER_FRAME_BACKBONES:
        backbone = _TemporalMean(backbone)
    return backbone


def recognizer_variables(model: nn.Module) -> dict:
    """The variables the JAX package's checkpoint of `model` holds:
    {"params"} for a TimeSformer recognizer, C3D or a transformer,
    {"params", "batch_stats"} for a CNN with BatchNorms."""
    cfg = getattr(getattr(model, "backbone", None), "cfg", None)
    if isinstance(cfg, TimeSformerConfig):
        return recognizer_variables_to_jax(model.state_dict(), cfg)
    return conv_recognizer_variables_to_jax(model.state_dict(), model)


def _tpn_config(ncfg: dict, num_classes: int) -> TPNConfig:
    nkw = {k: _deep_tuple(v) for k, v in dict(ncfg).items() if k != "type"}
    nkw.setdefault("aux_num_classes", num_classes)
    return TPNConfig(**nkw)


def build_recognition_model(cfg: Config, device=None,
                            input_shape=None) -> nn.Module:
    """The recognizer of `model` at the training init (f32 masters): a
    Recognizer3D, a BackboneClassifier over a pooled CNN, a transformer or VideoCLIP's
    pooled video encoder, a Recognizer3DCLIP ('CLIP'), a Recognizer2D
    over a per-frame backbone (TRNHead when model.head says so), or a
    TPNRecognizer (model.neck=dict(type='TPN')).  input_shape: the (T, H,
    W) of the videos, which sizes a Swin3D's tables (JAX's init reads it
    off the first batch)."""
    bcfg = dict(cfg["model.backbone"])
    btype = bcfg.pop("type", "TimeSformer")
    ncfg, hcfg = cfg.get("model.neck"), cfg.get("model.head")
    if ncfg and ncfg.get("type") != "TPN":
        raise ValueError(f"unknown neck type {ncfg.get('type')!r}")
    trn = hcfg and hcfg.get("type") in ("TRN", "TRNHead")
    if hcfg and (not trn or btype not in PER_FRAME_BACKBONES):
        raise ValueError(
            f"model.head {hcfg.get('type')!r}: a config selects TRNHead over "
            f"a per-frame backbone ({', '.join(PER_FRAME_BACKBONES)})")
    kw = {k: _deep_tuple(v) for k, v in bcfg.items()}
    num_classes = cfg["model.num_classes"]
    dev = resolve_device(device)
    if btype == "TimeSformer":
        backbone = TimeSformerConfig(**kw)
        model = Recognizer3D(backbone, num_classes, device=dev)
        model.load_state_dict(init_state_dict(backbone, INIT_SEED,
                                              num_classes=num_classes))
        return model
    if btype == "CLIP":
        model = Recognizer3DCLIP(CLIPConfig(**kw), num_classes, device=dev)
        model.load_state_dict(conv_init_state_dict(model, INIT_SEED))
        return model
    backbone = (VideoCLIPPooled(VideoCLIPConfig(**kw), dev)
                if btype == "VideoCLIP" else
                build_backbone(btype, kw, dev, input_shape))
    if ncfg:
        model = TPNRecognizer(backbone, _tpn_config(ncfg, num_classes),
                              num_classes)
    elif btype in PER_FRAME_BACKBONES:
        model = Recognizer2D(backbone, num_classes, trn=(
            {k: v for k, v in dict(hcfg).items() if k != "type"}
            if trn else None))
    else:
        model = BackboneClassifier(backbone, num_classes)
    model.load_state_dict(conv_init_state_dict(model, INIT_SEED))
    return model


def first_clip_shape(ds, batch_size: int):
    """(T, H, W) of the first clip of the first batch, the shape the JAX
    CLI's `model.init` reads off its first batch."""
    imgs, _items, _n = next(iter(ds.batches(batch_size)))
    return tuple(imgs.shape[2:5])


def _label_batches(ds, batch_size: int, device, order=None):
    """(first clip of each video f32, int64 labels, n valid) on `device`."""
    for imgs, items, n in ds.batches(batch_size, order):
        clips = torch.from_numpy(imgs[:, 0].astype(np.float32)).to(device)
        labels = torch.tensor([it["label"] for it in items],
                              dtype=torch.int64, device=device)
        yield clips, labels, n


def train_from_config(cfg: Config, work_dir: str,
                      resume: Optional[str] = None,
                      num_epochs: Optional[int] = None, *, device=None,
                      reader=None):
    """Train as the config says on `device` (None: the CUDA device); the
    f32 products run in f32 (TF32 off).  Returns (state, history)."""
    dev = resolve_device(device)
    no_tf32()
    tcfg = RecognitionTrainConfig(**cfg.get("optimizer", {}))
    pipe = build_pipeline(with_reader(cfg["data.pipeline"], reader))
    train_ds = VideoDataset(cfg["data.train.ann_file"], pipe,
                            cfg.get("data.train.data_prefix"))
    val_ds = VideoDataset(cfg["data.val.ann_file"], pipe,
                          cfg.get("data.val.data_prefix"))
    bs = cfg.get("data.videos_per_gpu", 8)
    model = build_recognition_model(
        cfg, dev, input_shape=first_clip_shape(train_ds, bs))
    if cfg.get("omnisource"):
        return _train_omnisource_from_config(cfg, model, train_ds, val_ds,
                                             bs, tcfg, work_dir, num_epochs,
                                             dev, reader, resume)
    if cfg.get("multigrid"):
        return _train_multigrid_from_config(cfg, model, train_ds, bs, tcfg,
                                            work_dir, num_epochs, dev)

    epochs = num_epochs or cfg.get("total_epochs", tcfg.num_epochs)
    # total_steps sizes the warmup-cosine schedule to the run
    tx = make_rec_optimizer(
        tcfg, total_steps=epochs * steps_per_epoch(len(train_ds), bs))
    state = init_rec_state(model, tx)
    generator = torch.Generator(device=dev)
    # a BatchNorm recognizer's statistics live in its buffers and ride in
    # the epoch states as "batch_stats"
    holder = model if has_batch_norm(model) else None
    blending = None
    bcfg = cfg.get("train_cfg.blending")
    if bcfg:
        from ..data.blending import make_blending
        blending = make_blending(bcfg["type"], cfg["model.num_classes"],
                                 bcfg.get("alpha", 0.2))
    if isinstance(model, TPNRecognizer):
        step = make_tpn_train_step_stats(model, bf16=tcfg.bf16,
                                         generator=generator, device=dev)
    else:
        make_step = (make_cls_train_step_stats if holder is not None
                     else make_cls_train_step)
        step = make_step(model, blending=blending, bf16=tcfg.bf16,
                         generator=generator, device=dev)
    save_best = best_checkpoint_manager(work_dir)
    sampler = ShardedSampler(len(train_ds), shuffle=True)

    start_epoch = 0
    if resume:
        payload, loop = load_train_state(resume, {"state": state,
                                                  "batch_stats": holder})
        state = payload["state"]
        start_epoch = int(loop.get("epoch", -1)) + 1

    eval_interval = cfg.get("eval_interval", tcfg.eval_interval)
    history = []
    for epoch in range(start_epoch, epochs):
        generator.manual_seed(DROPOUT_SEED + epoch)
        if blending is not None:
            blending.reseed(DROPOUT_SEED + epoch)
        losses, accs = [], []
        for clips, labels, _n in _label_batches(train_ds, bs, dev,
                                                sampler.indices(epoch)):
            state, logs = step(state, clips, labels)
            losses.append(logs["loss"])
            accs.append(logs["top1_acc"])
        rec = {"epoch": epoch,
               "loss": float(torch.stack(losses).double().mean()),
               "train_top1": float(torch.stack(accs).double().mean())}
        if (epoch + 1) % eval_interval == 0:
            report = evaluate_classification(
                model, _label_batches(val_ds, bs, dev))
            rec.update(report)
            save_best(recognizer_variables(model),
                      {"backbone": cfg["model.backbone"],
                       "num_classes": cfg["model.num_classes"]},
                      report["top1_acc"], {"epoch": epoch})
        save_train_state(os.path.join(work_dir, f"epoch_{epoch}"),
                         {"state": state, "batch_stats": holder},
                         {"epoch": epoch})
        history.append(rec)
        print(json.dumps(rec), flush=True)
    return state, history


def _clip_batches(ds, bs: int, dev, order=None):
    """(clips, labels) of _label_batches: full padded batches, as the JAX
    CLI feeds its multigrid and OmniSource loops."""
    for clips, labels, _n in _label_batches(ds, bs, dev, order):
        yield clips, labels


def _omnisource_total_steps(n_main: int, bs: int, epochs: int,
                            train_ratio) -> int:
    """The schedule's step count for train_omnisource: the main steps and
    one wave of sum(train_ratio[1:]) aux steps per train_ratio[0] main
    steps."""
    main_steps = steps_per_epoch(n_main, bs)
    waves_per_epoch = -(-main_steps // max(1, train_ratio[0]))
    return epochs * (main_steps + waves_per_epoch * sum(train_ratio[1:]))


def _save_omnisource_epoch(work_dir: str, epoch: int, state: RecTrainState,
                           holder, it: int) -> None:
    save_train_state(os.path.join(work_dir, f"epoch_{epoch}"),
                     {"omnisource": state, "batch_stats": holder},
                     {"epoch": epoch, "it": it})


def _train_omnisource_from_config(cfg: Config, model, train_ds, val_ds,
                                  bs: int, tcfg: RecognitionTrainConfig,
                                  work_dir: str, num_epochs, dev, reader,
                                  resume: Optional[str] = None):
    """OmniSource joint training (JAX cli/recognition_train.py:247-356):
    the aux sources reuse data.pipeline unless they carry their own."""
    oms = dict(cfg["omnisource"])
    sampler = ShardedSampler(len(train_ds), shuffle=True)
    epochs = num_epochs or cfg.get("total_epochs", tcfg.num_epochs)
    aux_sources = []
    for acfg in oms.get("aux", []):
        apipe = build_pipeline(with_reader(
            acfg.get("pipeline", cfg["data.pipeline"]), reader))
        ads = VideoDataset(acfg["ann_file"], apipe, acfg.get("data_prefix"))
        aux_sources.append(lambda ads=ads: _clip_batches(ads, bs, dev))
    train_ratio = tuple(oms.get("train_ratio",
                                (2,) + (1,) * len(aux_sources)))
    total_steps = _omnisource_total_steps(len(train_ds), bs, epochs,
                                          train_ratio)
    holder = model if has_batch_norm(model) else None
    state = init_rec_state(model, make_rec_optimizer(
        tcfg, total_steps=total_steps))
    start_epoch, init_it = 0, 0
    if resume:
        payload, loop = load_train_state(resume, {"omnisource": state,
                                                  "batch_stats": holder})
        state = payload["omnisource"]
        start_epoch = int(loop.get("epoch", -1)) + 1
        init_it = int(loop.get("it", 0))
    state, history = train_omnisource(
        model, tcfg, lambda epoch: _clip_batches(train_ds, bs, dev,
                                                 sampler.indices(epoch)),
        aux_sources, train_ratio, epochs,
        generator=torch.Generator(device=dev), total_steps=total_steps,
        start_epoch=start_epoch, state=state, init_it=init_it,
        epoch_callback=lambda epoch, s: _save_omnisource_epoch(
            work_dir, epoch, s["state"], holder, s["it"]),
        device=dev, dropout_seed=DROPOUT_SEED)
    report = evaluate_classification(model, _label_batches(val_ds, bs, dev))
    save_checkpoint(os.path.join(work_dir, "omnisource_final"),
                    recognizer_variables(model),
                    {"backbone": cfg["model.backbone"],
                     "num_classes": cfg["model.num_classes"]},
                    {"epochs": epochs, "omnisource": True, **report})
    for rec in history:
        print(json.dumps(rec), flush=True)
    print(json.dumps(report), flush=True)
    return state, history


def _train_multigrid_from_config(cfg: Config, model, train_ds, bs: int,
                                 tcfg: RecognitionTrainConfig, work_dir: str,
                                 num_epochs, dev):
    """Multigrid training (JAX cli/recognition_train.py:405-440)."""
    from ..train.multigrid import GridBucket, MultigridSchedule
    mg = dict(cfg["multigrid"])
    if "buckets" in mg:
        mg["buckets"] = tuple(GridBucket(*b) for b in mg["buckets"])
    schedule = MultigridSchedule(**mg)
    sampler = ShardedSampler(len(train_ds), shuffle=True)
    epochs = num_epochs or cfg.get("total_epochs", tcfg.num_epochs)
    state, history = train_multigrid(
        model, tcfg, schedule,
        lambda epoch: _clip_batches(train_ds, bs, dev,
                                    sampler.indices(epoch)),
        epochs, generator=torch.Generator(device=dev),
        total_steps=epochs * steps_per_epoch(len(train_ds), bs),
        device=dev, dropout_seed=DROPOUT_SEED)
    save_checkpoint(os.path.join(work_dir, "multigrid_final"),
                    recognizer_variables(model),
                    {"backbone": cfg["model.backbone"],
                     "num_classes": cfg["model.num_classes"]},
                    {"epochs": epochs, "multigrid": True})
    for rec in history:
        print(json.dumps(rec), flush=True)
    return state, history


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("config")
    parser.add_argument("--work_dir", required=True)
    parser.add_argument("--resume", nargs="?", const="auto", default=None)
    parser.add_argument("--total_epochs", type=int, default=None)
    parser.add_argument("--cfg-options", nargs="*", default=[])
    parser.add_argument("--device", default=None,
                        help="default: the CUDA device")
    args = parser.parse_args(argv)

    cfg = Config.fromfile(args.config).merge_from_options(args.cfg_options)
    os.makedirs(args.work_dir, exist_ok=True)
    resume = args.resume
    if resume == "auto":
        resume = latest_checkpoint(args.work_dir)
    _, history = train_from_config(cfg, args.work_dir, resume,
                                   args.total_epochs, device=args.device)
    return history


if __name__ == "__main__":
    main()
