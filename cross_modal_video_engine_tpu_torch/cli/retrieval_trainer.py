"""LINAS dual-encoder training CLI.

Counterpart of cross_modal_video_engine_tpu/cli/retrieval_trainer.py and
parity surface for LINAS-engine/trainer.py:109-449: the epoch loop with
per-epoch validation (`retrieval_tester.evaluate`, rsum the selection
score), the best checkpoint kept (`model_best`, in the JAX package's
format), `val_metric_hist.txt`, LR decay x0.99 an epoch and x0.5 after 3
non-improving epochs, early stop after 6, `epoch_N` train states every
`checkpoint_interval` epochs and `--resume` from one (either package's).

Usage:
  python -m cross_modal_video_engine_tpu_torch.cli.retrieval_trainer \
      --rootpath ROOT --trainCollection TRAIN --valCollection VAL \
      --visual_feature F --out_dir OUT [--num_epochs 50] \
      [--checkpoint_interval 1] [--resume OUT/epoch_N] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..convert.from_jax import dual_encoding_variables_to_jax
from ..models.dual_encoding import DualEncoding, DualEncodingConfig
from ..train.checkpoint import best_checkpoint_manager
from ..train.linas_trainer import (NO_MESH, EpochScheduler,
                                   LinasTrainConfig, get_learning_rate,
                                   init_mask_state, init_train_state,
                                   make_mask_optimizer, make_mask_train_step,
                                   make_optimizer, make_train_step,
                                   mask_matrix)
from ..train.resume import load_train_state, save_train_state
from ..utils.device import resolve_device
from ..utils.precision import no_tf32
from .common import load_dataset
from .retrieval_tester import evaluate


def train(model_cfg: DualEncodingConfig, train_cfg: LinasTrainConfig,
          train_set, val_set, out_dir: str, batch_size: int = 128,
          seed: int = 0, log_every: int = 10, num_epochs: int | None = None,
          resume: str | None = None, checkpoint_interval: int = 0,
          device=None, mesh=None):
    """Trains on `device` (None: the CUDA device), where both datasets'
    batches must go.  The weights start from `seeded_state_dict(model_cfg,
    seed)`; dropout draws from a torch.Generator seeded with seed + 1.
    The model trains in f32 as the JAX package does: TF32 is turned off
    for the process.  Returns (state, history, path of model_best)."""
    if mesh is not None:
        raise NotImplementedError(NO_MESH)
    dev = resolve_device(device)
    for name, ds in (("train_set", train_set), ("val_set", val_set)):
        if ds.device.type != dev.type:
            raise ValueError(f"{name}'s batches go to {ds.device}, the "
                             f"model to {dev}")
    no_tf32()
    model = DualEncoding(model_cfg, device=dev)
    state = init_train_state(model, make_optimizer(train_cfg), seed)
    generator = torch.Generator(device=dev).manual_seed(seed + 1)
    step_fn = make_train_step(model, train_cfg, generator, device=dev)
    # 'adapt' similarity distill: the learned (pa1, pa2) mask trains in a
    # second lr x10 step (reference model.py:584-598 optimizer2 +
    # train_mask :896-912)
    use_adapt = (train_cfg.distill_with_similarity
                 and train_cfg.similarity_type == "adapt")
    if use_adapt:
        tx2 = make_mask_optimizer(train_cfg)
        mask_state = init_mask_state(tx2, dev)
        mask_step = make_mask_train_step(model)
    scheduler = EpochScheduler(train_cfg)
    save_best = best_checkpoint_manager(out_dir)

    start_epoch = 0
    if resume:
        # the learned adapt mask (pa and its Adam state) resumes too
        _, loop = load_train_state(
            resume, {"state": state} | ({"mask": mask_state}
                                        if use_adapt else {}))
        start_epoch = int(loop.get("epoch", -1)) + 1
        scheduler.best = float(loop.get("best", -np.inf))
        scheduler.no_impr = int(loop.get("no_impr", 0))
        scheduler.since_halve = int(loop.get("since_halve", 0))
        print(f"resumed from {resume}: epoch {start_epoch}, "
              f"best={scheduler.best:.2f}")

    history = []
    epochs = num_epochs or train_cfg.num_epochs
    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        losses = []
        # the padded tail batch of an epoch trains too, as in the JAX loop
        for i, (videos, text, support, _n) in enumerate(
                train_set.train_batches(batch_size, seed + epoch)):
            if use_adapt:
                adapt = mask_matrix(mask_state.pa, videos.frames.shape[0])
                state, logs = step_fn(state, videos, text, support, adapt)
                mask_state, _mask_loss = mask_step(mask_state, state,
                                                   videos, text, support)
            else:
                state, logs = step_fn(state, videos, text, support)
            losses.append(float(logs["loss"]))
            if log_every and i % log_every == 0:
                print(f"epoch {epoch} step {i}: loss={losses[-1]:.3f} "
                      f"lr={get_learning_rate(state):.2e}")

        model.eval()
        _, report = evaluate(model, val_set, batch_size)
        rsum = report["rsum"]
        state, is_best, stop = scheduler.on_epoch_end(state, rsum)
        history.append({"epoch": epoch, "loss": float(np.mean(losses)),
                        "rsum": rsum, "lr": get_learning_rate(state),
                        "time": time.time() - t0})
        print(f"epoch {epoch}: mean_loss={history[-1]['loss']:.3f} "
              f"rsum={rsum:.2f} best={scheduler.best:.2f}"
              f"{' *' if is_best else ''}")
        if is_best:
            save_best(dual_encoding_variables_to_jax(model.state_dict()),
                      model_cfg, rsum, {"epoch": epoch})
        with open(os.path.join(out_dir, "val_metric_hist.txt"), "a") as f:
            f.write(f"{epoch} {rsum:.4f}\n")
        if checkpoint_interval and (epoch + 1) % checkpoint_interval == 0:
            payload = {"state": state}
            if use_adapt:
                payload["mask"] = mask_state
            save_train_state(
                os.path.join(out_dir, f"epoch_{epoch}"), payload,
                {"epoch": epoch, "best": scheduler.best,
                 "no_impr": scheduler.no_impr,
                 "since_halve": scheduler.since_halve})
        if stop:
            print(f"early stop at epoch {epoch}")
            break

    return state, history, os.path.join(out_dir, "model_best")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--rootpath", required=True)
    parser.add_argument("--trainCollection", required=True)
    parser.add_argument("--valCollection", required=True)
    parser.add_argument("--visual_feature", required=True)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--num_epochs", type=int, default=50)
    parser.add_argument("--learning_rate", type=float, default=1e-4)
    parser.add_argument("--support_set_number", type=int, default=8)
    parser.add_argument("--style", default="distill_from_best_model")
    parser.add_argument("--student_model", default="de+map")
    parser.add_argument("--visual_feat_dim", type=int, default=2048)
    parser.add_argument("--config_json", default=None,
                        help="JSON dict of DualEncodingConfig overrides")
    parser.add_argument("--resume", default=None,
                        help="epoch_N train-state dir to resume from")
    parser.add_argument("--checkpoint_interval", type=int, default=0,
                        help="save full train state every N epochs")
    parser.add_argument("--device", default=None,
                        help="default: the CUDA device")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    train_set = load_dataset(args.rootpath, args.trainCollection,
                             args.visual_feature,
                             support_set_number=args.support_set_number,
                             device=dev)
    val_set = load_dataset(args.rootpath, args.valCollection,
                           args.visual_feature, device=dev)
    overrides = json.loads(args.config_json) if args.config_json else {}
    for key in ("visual_kernel_sizes", "text_kernel_sizes"):
        if key in overrides:
            overrides[key] = tuple(overrides[key])
    model_cfg = DualEncodingConfig(
        visual_feat_dim=args.visual_feat_dim,
        vocab_size=len(train_set.vocab),
        bow_vocab_size=train_set.bow2vec.ndims,
        style=args.style, student_model=args.student_model, **overrides)
    train_cfg = LinasTrainConfig(learning_rate=args.learning_rate,
                                 num_epochs=args.num_epochs)
    os.makedirs(args.out_dir, exist_ok=True)
    state, history, best = train(model_cfg, train_cfg, train_set, val_set,
                                 args.out_dir, args.batch_size,
                                 resume=args.resume,
                                 checkpoint_interval=args.checkpoint_interval,
                                 device=dev)
    # a resume with no epochs left legitimately yields an empty history
    print(json.dumps(history[-1] if history else {"resumed_complete": True}))
    return history


if __name__ == "__main__":
    main()
