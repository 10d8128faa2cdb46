"""Config-driven recognition training CLI, the TimeSformer arm.

Counterpart of cross_modal_video_engine_tpu/cli/recognition_train.py (MCT
tools/train.py) for `model.backbone.type='TimeSformer'`: a Recognizer3D
trained with cross entropy, on the card unless `--device cpu`.

  python -m cross_modal_video_engine_tpu_torch.cli.recognition_train \\
      CONFIG --work_dir WORK [--resume [EPOCH_DIR]] [--total_epochs N] \\
      [--cfg-options optimizer.bf16=True \\
       model.backbone.attention_type=joint_space_time \\
       model.backbone.use_flash_attention=True] [--device cpu]

Config (configs/recognition/timesformer_divst_8x32_k400.py): `model`
(backbone, num_classes), `data` (train/val `filename label` splits,
pipeline, videos_per_gpu), `optimizer` (train/recognition_trainer.
RecognitionTrainConfig: sgd or adamw, clip, warmup, `bf16`),
`total_epochs`, `eval_interval`.

The epoch loop is the JAX CLI's: train on `ShardedSampler`'s order, every
`eval_interval` epochs top-k and mean class accuracy on the val split,
`model_best` kept by `top1_acc` with the {backbone, num_classes} config
that `api.init_recognizer`, `cli/explain_demo.load_explain_model` and the
`/explain` route load, `epoch_{n}` each epoch's train state in the JAX
package's layout (`--resume` with no directory takes the newest).  With
`optimizer.bf16=True` the masters stay f32 (also under a backbone
configured in bfloat16) and the step runs in bfloat16.  The weights start
from `models.recognizer.init_state_dict` (numpy seed 0); the dropouts draw
from a generator seeded anew each epoch (seed 1 + epoch).
`train_from_config(..., reader=)` hands the pipeline a decord-alike
reader.  Other backbones, necks and heads, OmniSource, multigrid and
blending come with slice 5 (ROADMAP.md queue 1 item 8).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..convert.from_jax import recognizer_variables_to_jax
from ..data.datasets import ShardedSampler, VideoDataset
from ..data.pipelines import build_pipeline, with_reader
from ..models.recognizer import Recognizer3D, init_state_dict
from ..models.timesformer import TimeSformerConfig
from ..train.checkpoint import best_checkpoint_manager
from ..train.recognition_trainer import (
    SLICE5, RecognitionTrainConfig, evaluate_classification, init_rec_state,
    make_cls_train_step, make_rec_optimizer)
from ..train.resume import (latest_checkpoint, load_train_state,
                            save_train_state)
from ..utils.device import resolve_device
from ..utils.precision import no_tf32
from .caption_train import DROPOUT_SEED, INIT_SEED, steps_per_epoch


def _deep_tuple(v):
    if isinstance(v, list):
        return tuple(_deep_tuple(x) for x in v)
    return v


def build_recognition_model(cfg: Config, device=None,
                            dtype: Optional[str] = None) -> Recognizer3D:
    """The Recognizer3D of `model` at the training init; dtype overrides
    the backbone's (the bf16 step's f32 masters).  Every other family,
    neck or head raises."""
    bcfg = dict(cfg["model.backbone"])
    btype = bcfg.pop("type", "TimeSformer")
    for part in ("model.neck", "model.head"):
        if cfg.get(part):
            raise NotImplementedError(SLICE5.format(part))
    if btype != "TimeSformer":
        raise NotImplementedError(SLICE5.format(f"the {btype!r} backbone"))
    kw = {k: _deep_tuple(v) for k, v in bcfg.items()}
    if dtype is not None:
        kw["dtype"] = dtype
    backbone = TimeSformerConfig(**kw)
    num_classes = cfg["model.num_classes"]
    model = Recognizer3D(backbone, num_classes, device=resolve_device(device))
    model.load_state_dict(init_state_dict(backbone, INIT_SEED,
                                          num_classes=num_classes))
    return model


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
    for feature in ("omnisource", "multigrid", "train_cfg.blending"):
        if cfg.get(feature):
            raise NotImplementedError(SLICE5.format(feature))
    dev = resolve_device(device)
    no_tf32()
    tcfg = RecognitionTrainConfig(**cfg.get("optimizer", {}))
    model = build_recognition_model(cfg, dev,
                                    "float32" if tcfg.bf16 else None)
    pipe = build_pipeline(with_reader(cfg["data.pipeline"], reader))
    train_ds = VideoDataset(cfg["data.train.ann_file"], pipe,
                            cfg.get("data.train.data_prefix"))
    val_ds = VideoDataset(cfg["data.val.ann_file"], pipe,
                          cfg.get("data.val.data_prefix"))
    bs = cfg.get("data.videos_per_gpu", 8)

    epochs = num_epochs or cfg.get("total_epochs", tcfg.num_epochs)
    # total_steps sizes the warmup-cosine schedule to the run
    tx = make_rec_optimizer(
        tcfg, total_steps=epochs * steps_per_epoch(len(train_ds), bs))
    state = init_rec_state(model, tx)
    generator = torch.Generator(device=dev)
    step = make_cls_train_step(model, bf16=tcfg.bf16, generator=generator,
                               device=dev)
    save_best = best_checkpoint_manager(work_dir)
    sampler = ShardedSampler(len(train_ds), shuffle=True)

    start_epoch = 0
    if resume:
        payload, loop = load_train_state(resume, {"state": state,
                                                  "batch_stats": None})
        state = payload["state"]
        start_epoch = int(loop.get("epoch", -1)) + 1

    eval_interval = cfg.get("eval_interval", tcfg.eval_interval)
    history = []
    for epoch in range(start_epoch, epochs):
        generator.manual_seed(DROPOUT_SEED + epoch)
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
            save_best(recognizer_variables_to_jax(model.state_dict(),
                                                  model.backbone.cfg),
                      {"backbone": cfg["model.backbone"],
                       "num_classes": cfg["model.num_classes"]},
                      report["top1_acc"], {"epoch": epoch})
        save_train_state(os.path.join(work_dir, f"epoch_{epoch}"),
                         {"state": state, "batch_stats": None},
                         {"epoch": epoch})
        history.append(rec)
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
