"""Combiner training CLI (MultiFusion combiner_train.py equivalent).

Counterpart of cross_modal_video_engine_tpu/cli/combiner_trainer.py.
Trains the fusion head over a ComposedVideoDataset with the CLIP towers
frozen: video features precomputed (h5/npz store), modification texts
encoded each batch by the frozen ViT text tower (the fused sublayer
kernels on the card).  Validates every `validation_frequency` epochs with
reference-video masking over the whole validation split and keeps the
best checkpoint by arithmetic-mean recall (combiner_train.py:427-438) as
`model_best` in the JAX package's format, with the CombinerConfig.

  python -m cross_modal_video_engine_tpu_torch.cli.combiner_trainer \
      --triplets T.tsv --features_root FEATS --clip_checkpoint CKPT \
      --merges merges.txt --out_dir OUT [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from ..convert.from_jax import combiner_variables_to_jax
from ..data.composed_dataset import ComposedVideoDataset, FeatureStore
from ..models.combiner import Combiner, CombinerConfig
from ..train.checkpoint import best_checkpoint_manager
from ..train.combiner_trainer import (
    CombinerTrainConfig, composed_rank_eval, init_combiner_state,
    make_combiner_optimizer, make_combiner_train_step)
from ..utils.bpe import BPETokenizer
from ..utils.device import resolve_device
from .composed_inference import encode_text, load_clip_tower


def encode_texts(clip_model, tok, captions, context_length) -> torch.Tensor:
    """(B, E) f32 text features of the frozen tower, on its device."""
    return encode_text(clip_model, tok, list(captions), context_length)


def build_index_features(dataset: ComposedVideoDataset) -> np.ndarray:
    """(n_videos, F, D) high features in video_names order."""
    return np.stack([dataset._features(name)[0]
                     for name in dataset.video_names])


def _feats(batch, prefix: str, device):
    return (torch.from_numpy(batch[f"{prefix}_high"]).to(device),
            torch.from_numpy(batch[f"{prefix}_middle"]).to(device))


def validation_orders(combiner: Combiner, dataset: ComposedVideoDataset,
                      text_encode_fn: Callable, index_high: torch.Tensor,
                      batch_size: int, top_k: int = 50):
    """Every relative-mode triplet of `dataset` ranked, reference video
    masked: (orders (Q, top_k), ground-truth rows (Q,))."""
    device = combiner.device
    orders, gts = [], []
    for batch in dataset.batches(batch_size):
        n = batch["n_valid"]
        order, _ = composed_rank_eval(
            combiner, _feats(batch, "ref", device),
            text_encode_fn(batch["captions"]), index_high,
            torch.from_numpy(batch["ref_rows"]),
            torch.from_numpy(batch["target_rows"]), top_k=top_k)
        orders.append(order[:n])
        gts.append(np.asarray(batch["target_rows"])[:n])
    return np.concatenate(orders), np.concatenate(gts)


def recalls(order: np.ndarray, gts: np.ndarray) -> dict:
    hits = order == gts[:, None]
    return {f"recall_at{k}": float(hits[:, : min(k, order.shape[1])]
                                   .any(1).mean() * 100)
            for k in (1, 5, 10, 50)}


def train_combiner(combiner: Combiner, dataset: ComposedVideoDataset,
                   text_encode_fn: Callable, train_cfg: CombinerTrainConfig,
                   out_dir: str, batch_size: int = 32, seed: int = 0,
                   num_epochs: Optional[int] = None,
                   val_dataset: Optional[ComposedVideoDataset] = None):
    """Train from `init_combiner_state(combiner, ..., seed)` on the
    combiner's device; dropout draws from a generator seeded with `seed`.
    Returns (state, history); each epoch's record is also printed as a
    JSON line."""
    device = combiner.device
    state = init_combiner_state(combiner, make_combiner_optimizer(train_cfg),
                                seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    step = make_combiner_train_step(combiner, gen)
    save_best = best_checkpoint_manager(out_dir)
    history = []
    val_ds = val_dataset or dataset
    index_high = torch.from_numpy(build_index_features(val_ds)).to(device)

    for epoch in range(num_epochs or train_cfg.num_epochs):
        losses = []
        for batch in dataset.batches(batch_size, shuffle=True,
                                     seed=seed + epoch):
            text = text_encode_fn(batch["captions"])
            state, loss = step(state, _feats(batch, "ref", device), text,
                               _feats(batch, "target", device))
            losses.append(loss)
        step_losses = torch.stack(losses).cpu().tolist()     # one fetch
        rec = {"epoch": epoch, "loss": float(np.mean(step_losses)),
               "step_losses": step_losses}
        if epoch % train_cfg.validation_frequency == 0:
            # the whole validation split (combiner_train.py:427-438)
            metrics = recalls(*validation_orders(
                combiner, val_ds, text_encode_fn, index_high, batch_size))
            rec.update(metrics)
            mean_recall = float(np.mean(list(metrics.values())))
            rec["mean_recall"] = mean_recall
            # the CombinerConfig goes with the weights: composed_validate
            # and the route rebuild the model from it
            save_best(combiner_variables_to_jax(combiner.state_dict(),
                                                combiner.cfg),
                      dataclasses.asdict(combiner.cfg), mean_recall,
                      {"epoch": epoch, **metrics})
        history.append(rec)
        print(json.dumps({k: v for k, v in rec.items()
                          if k != "step_losses"}))
    return state, history


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--triplets", required=True)
    parser.add_argument("--features_root", required=True)
    parser.add_argument("--id2name", default=None)
    parser.add_argument("--clip_checkpoint", required=True)
    parser.add_argument("--merges", required=True)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--num_epochs", type=int, default=30)
    parser.add_argument("--learning_rate", type=float, default=2e-5)
    parser.add_argument("--projection_dim", type=int, default=2560)
    parser.add_argument("--hidden_dim", type=int, default=5120)
    parser.add_argument("--device", default=None,
                        help="default: the CUDA device")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    # the frozen text tower: a ViT checkpoint, fused sublayers on the card
    clip_model, clip_cfg = load_clip_tower(args.clip_checkpoint, device)
    tok = BPETokenizer(args.merges)
    dataset = ComposedVideoDataset(
        args.triplets, FeatureStore({"main": args.features_root}),
        args.id2name)
    comb_cfg = CombinerConfig(clip_feature_dim=clip_cfg.embed_dim,
                              projection_dim=args.projection_dim,
                              hidden_dim=args.hidden_dim)
    # built on the meta device: train_combiner draws the weights
    combiner = Combiner(comb_cfg, device="meta").to_empty(device=device)
    tcfg = CombinerTrainConfig(learning_rate=args.learning_rate,
                               num_epochs=args.num_epochs)
    os.makedirs(args.out_dir, exist_ok=True)

    def text_fn(caps):
        return encode_texts(clip_model, tok, caps, clip_cfg.context_length)

    _, history = train_combiner(combiner, dataset, text_fn, tcfg,
                                args.out_dir, args.batch_size,
                                num_epochs=args.num_epochs)
    return history


if __name__ == "__main__":
    main()
