"""Config-driven caption (label-sequence) training CLI.

Counterpart of cross_modal_video_engine_tpu/cli/caption_train.py, the
seq_generate family's tools/train.py: a TimeSformer + RNN decoder
(Recognizer3DRelseq), or a CNN (ResNet3D/I3D, CSN, SlowFast, X3D, C3D,
R(2+1)D, or a per-frame TSM, TSN, TIN, TANet or MobileNetV2-TSM pooled
over time by `_TemporalMean`) + RNN decoder (RecognizerRelseq, its
BatchNorms trained by `make_seq_train_step_stats`), or a transformer
(MViT, VideoMAEViT, Swin3D) + RNN decoder (RecognizerRelseq, trained by
`make_seq_train_step`), trained with the SeqMLL loss under teacher
forcing, on the card unless `--device cpu`.

  python -m cross_modal_video_engine_tpu_torch.cli.caption_train CONFIG \\
      --work_dir WORK [--resume] [--total_epochs N] \\
      [--cfg-options model.backbone.attention_type=joint_space_time \\
       model.backbone.use_flash_attention=True] [--device cpu]

Config (configs/seq_generate/timesformer_relseq.py, i3d_relseq.py,
slowfast_relseq.py, x3d_relseq.py, tsm_relseq.py, mvit_relseq.py,
videomae_relseq.py):

    model = dict(backbone=dict(num_frames=8, img_size=224, ...),
                 decoder=dict(num_classes=36, in_channels=768, max_len=5))
    data = dict(train=dict(ann_file=..., data_prefix=...), val=dict(...),
                pipeline=[...], videos_per_gpu=8)
    optimizer = dict(optimizer='sgd', learning_rate=0.005)
    total_epochs = 15

The weights start from `models.recognizer.init_state_dict` or
`conv_init_state_dict` (flax's init schemes, numpy seed 0).  Each epoch
walks `ShardedSampler`'s order; the dropouts draw from a generator seeded
anew each epoch (seed 1 + epoch), so a run resumed from an epoch state
repeats the epochs that follow.
Validation every `eval_interval` epochs scores the greedy decode of each
video's first clip with the sequence-aware mAP (`cli/caption_test`'s
`eval_labels`); `model_best` keeps the best by `seq_mAP` with the
{backbone, decoder} config (a CNN's backbone config with its `type`)
and, for the CNNs with BatchNorms, the `batch_stats`, which
`api.init_recognizer` and the `/caption` route load; `epoch_{n}` holds
each epoch's train state in the JAX package's layout (train/resume.py),
so `--resume` continues a run either package started.  `train_from_config(..., reader=)` hands the
pipeline's DecordInit a decord-alike reader in place of opening files (a
machine without cv2).  The model is built after the first training batch
is read, as the JAX CLI's init is (a Swin3D's tables follow its shape);
'CLIP' and 'VideoCLIP' are no caption backbones, in either package.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..data.datasets import ShardedSampler, VideoDatasetRelseq
from ..data.pipelines import build_pipeline, with_reader
from ..metrics.accuracy import seq_average_precision
from ..models.decoder_head import RNNDecoderConfig
from ..models.recognizer import (Recognizer3DRelseq, RecognizerRelseq,
                                 conv_init_state_dict, init_state_dict)
from ..models.timesformer import TimeSformerConfig
from ..train.checkpoint import best_checkpoint_manager
from ..train.recognition_trainer import (RecognitionTrainConfig,
                                         init_rec_state, make_rec_optimizer,
                                         make_seq_train_step,
                                         make_seq_train_step_stats)
from ..train.resume import (latest_checkpoint, load_train_state,
                            save_train_state)
from ..utils.device import resolve_device
from ..utils.precision import no_tf32
from .caption_test import eval_labels

INIT_SEED, DROPOUT_SEED = 0, 1


def steps_per_epoch(n: int, batch_size: int) -> int:
    return max(1, (n + batch_size - 1) // batch_size)


def _seq_batches(ds, batch_size: int, device, order=None):
    """(first clip of each video (B, T, H, W, 3) f32, targets (B, max_len,
    C), mask (B, max_len), items, n valid) on `device`."""
    for imgs, items, n in ds.batches(batch_size, order):
        clips = torch.from_numpy(imgs[:, 0].astype(np.float32)).to(device)
        targets = torch.from_numpy(
            np.stack([it["label"] for it in items])).to(device)
        mask = torch.from_numpy(np.stack([it["mask"] for it in items])) \
            .to(device)
        yield clips, targets, mask, items, n


def evaluate_caption(model: Recognizer3DRelseq, ds, batch_size: int) -> dict:
    """The greedy decode (eval mode, no graph) of each video's first clip,
    scored by the sequence-aware mAP."""
    device = next(model.parameters()).device
    model.eval()
    scores, labels = [], []
    with torch.no_grad():
        for clips, _t, _m, items, n in _seq_batches(ds, batch_size, device):
            probs = model.forward_test(clips).float().cpu().numpy()
            for i in range(n):
                scores.append(probs[i])
                labels.append(eval_labels(items[i]["label"],
                                          items[i]["mask"]))
    aps = seq_average_precision(scores, labels)
    return {"seq_mAP": float(np.mean(aps)), "num_videos": len(scores)}


def build_caption_model(cfg: Config, device=None, input_shape=None):
    """(Recognizer3DRelseq or RecognizerRelseq at the training init, the
    backbone config dict saved with checkpoints, the decoder config
    dict).  input_shape: the videos' (T, H, W), which sizes a Swin3D's
    tables."""
    from .recognition_train import _deep_tuple, build_caption_backbone
    bb_kw = {k: _deep_tuple(v) for k, v in cfg["model.backbone"].items()}
    btype = bb_kw.pop("type", "TimeSformer")
    dec_kw = dict(cfg["model.decoder"])
    dcfg = RNNDecoderConfig(**dec_kw)
    dev = resolve_device(device)
    if btype != "TimeSformer":
        model = RecognizerRelseq(build_caption_backbone(btype, bb_kw, dev,
                                                        input_shape), dcfg)
        model.load_state_dict(conv_init_state_dict(model, INIT_SEED))
        return model, dict(bb_kw, type=btype), dec_kw
    bcfg = TimeSformerConfig(**bb_kw)
    model = Recognizer3DRelseq(bcfg, dcfg, device=dev)
    model.load_state_dict(init_state_dict(bcfg, INIT_SEED, decoder_cfg=dcfg))
    return model, bb_kw, dec_kw


def train_from_config(cfg: Config, work_dir: str,
                      resume: Optional[str] = None,
                      num_epochs: Optional[int] = None, *, device=None,
                      reader=None):
    """Train as the config says on `device` (None: the CUDA device); the
    f32 products run in f32 (TF32 off).  Returns the history, one record
    an epoch."""
    from .recognition_train import (first_clip_shape, has_batch_norm,
                                    recognizer_variables)
    dev = resolve_device(device)
    no_tf32()
    dec_kw = dict(cfg["model.decoder"])
    pipe = build_pipeline(with_reader(cfg["data.pipeline"], reader))
    num_classes = dec_kw["num_classes"]
    max_len = dec_kw.get("max_len", 5)
    train_ds = VideoDatasetRelseq(
        cfg["data.train.ann_file"], pipe, num_classes=num_classes,
        max_len=max_len, data_prefix=cfg.get("data.train.data_prefix"))
    val_ds = VideoDatasetRelseq(
        cfg["data.val.ann_file"], pipe, num_classes=num_classes,
        max_len=max_len, data_prefix=cfg.get("data.val.data_prefix"))
    bs = cfg.get("data.videos_per_gpu", 8)
    model, saved_bb, dec_kw = build_caption_model(
        cfg, dev, first_clip_shape(train_ds, bs))

    tcfg = RecognitionTrainConfig(**cfg.get("optimizer", {}))
    epochs = num_epochs or cfg.get("total_epochs", tcfg.num_epochs)
    # total_steps sizes the warmup-cosine schedule to the run
    tx = make_rec_optimizer(
        tcfg, total_steps=epochs * steps_per_epoch(len(train_ds), bs))
    state = init_rec_state(model, tx)
    generator = torch.Generator(device=dev)
    holder = model if has_batch_norm(model) else None
    step = (make_seq_train_step_stats if holder is not None
            else make_seq_train_step)(model, generator, device=dev)
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
        losses = []
        for clips, targets, mask, _items, _n in _seq_batches(
                train_ds, bs, dev, sampler.indices(epoch)):
            state, logs = step(state, clips, targets, mask)
            losses.append(logs["loss"])
        rec = {"epoch": epoch,
               "loss": float(torch.stack(losses).double().mean())}
        if (epoch + 1) % eval_interval == 0:
            report = evaluate_caption(model, val_ds, bs)
            rec.update(report)
            save_best(recognizer_variables(model),
                      {"backbone": saved_bb, "decoder": dec_kw},
                      report["seq_mAP"], {"epoch": epoch})
        save_train_state(os.path.join(work_dir, f"epoch_{epoch}"),
                         {"state": state, "batch_stats": holder},
                         {"epoch": epoch})
        history.append(rec)
        print(json.dumps(rec), flush=True)
    return history


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("config")
    parser.add_argument("--work_dir", required=True)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--total_epochs", type=int, default=None)
    parser.add_argument("--cfg-options", nargs="*", default=[])
    parser.add_argument("--device", default=None,
                        help="default: the CUDA device")
    args = parser.parse_args(argv)

    cfg = Config.fromfile(args.config).merge_from_options(args.cfg_options)
    os.makedirs(args.work_dir, exist_ok=True)
    resume = latest_checkpoint(args.work_dir) if args.resume else None
    return train_from_config(cfg, args.work_dir, resume=resume,
                             num_epochs=args.total_epochs,
                             device=args.device)


if __name__ == "__main__":
    main()
