"""Config-driven temporal-localization training CLI.

Counterpart of cross_modal_video_engine_tpu/cli/localization_train.py
(the localization half of MCT tools/train.py + tools/test.py), with its
four arms:
* BMN over ActivityNet-style features, evaluated with AR@AN/AUC;
* BSN TEM (stage 1) over the same features;
* BSN PEM (stage 3) over PGM proposal csv/npy artifacts
  (`cli.misc_tools bsn_pgm` is stage 2), with the reference's u-mask
  balanced loss and score-fusion + soft-NMS AR@AN eval
  (reference models/localizers/bsn.py:229-395);
* SSN over snippet features + a tag-style proposal file
  (reference models/localizers/ssn.py:11 + ssn_dataset.py sampler).

It keeps the JAX CLI's choices: the tail batch padded with its first item
(`_batches`), the epoch permutations `default_rng(epoch)`, PEM's rows
cycled by `np.resize`, SSN's batches by `np.resize`, the optimizer chains
(`train/localization_trainer.make_loc_optimizer`), and the checkpoints
`bmn_final`, `tem_final`, `pem_final` and `ssn_final` in the JAX
directory format, so either package reads the other's.  The models start
from the training init (`models/recognizer.conv_init_state_dict`, seed
0).  The BMN and PEM losses draw two uniforms a step: `draws(step, shape)
-> (u_m, u_l)` hands them in (the JAX CLI's own draws, in the tests);
without it they come from a CPU generator seeded 0 (BMN) or 1 (PEM), the
seeds of the JAX CLI's keys.

  python -m cross_modal_video_engine_tpu_torch.cli.localization_train \\
      CONFIG --work_dir W [--cfg-options ...] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from ..config import Config
from ..convert.from_jax import (localizer_state_dict_from_jax,
                                localizer_variables_to_jax)
from ..data.datasets_extra import ActivityNetDataset, SSNDataset
from ..metrics.proposals import average_recall_at_avg_proposals
from ..models.bmn import BMN, BMNConfig, generate_proposals, soft_nms
from ..models.bsn import PEM, TEM
from ..models.recognizer import conv_init_state_dict
from ..models.ssn import SSNConfig, SSNHead, stpp_matrix
from ..train.checkpoint import load_checkpoint, save_checkpoint
from ..train.localization_trainer import (SSNSamplerConfig, bm_mask,
                                          bmn_labels, bsn_tem_labels,
                                          init_loc_state,
                                          make_bmn_train_step,
                                          make_bsn_pem_train_step,
                                          make_bsn_tem_train_step,
                                          make_loc_optimizer,
                                          make_ssn_batch_train_step)
from ..utils.device import resolve_device
from ..utils.precision import no_tf32

INIT_SEED = 0
Draws = Callable[[int, tuple], tuple]


def _batches(ds: ActivityNetDataset, batch_size: int, order=None):
    """Yields (items, n_real): the tail batch pads by repeating its
    first item, so every batch has one shape."""
    order = range(len(ds)) if order is None else order
    buf = []
    for i in order:
        buf.append(ds[i])
        if len(buf) == batch_size:
            yield buf, batch_size
            buf = []
    if buf:
        n = len(buf)
        while len(buf) < batch_size:
            buf.append(buf[0])
        yield buf, n


def _stack(arrays, dev) -> torch.Tensor:
    return torch.from_numpy(np.stack(arrays)).to(dev)


def _init(model: torch.nn.Module) -> torch.nn.Module:
    model.load_state_dict(conv_init_state_dict(model, INIT_SEED))
    return model


def _draws_at(draws: Optional[Draws], step: int, shape):
    return None if draws is None else draws(step, tuple(shape))


@torch.no_grad()
def evaluate_bmn_proposals(model: BMN, ds: ActivityNetDataset,
                           batch_size: int = 8, top_k: int = 100,
                           device=None):
    """Inference + score fusion + soft-NMS per video, then AR@AN/AUC
    (reference tools/test.py --eval AR@AN)."""
    dev = resolve_device(device)
    model.eval()
    gt, props, total = {}, {}, 0
    for batch, n_real in _batches(ds, batch_size):
        out = model(_stack([b["features"] for b in batch], dev))
        out = {k: v.float().cpu().numpy() for k, v in out.items()}
        for j, b in enumerate(batch[:n_real]):
            rows = generate_proposals(
                out["tem_start"][j], out["tem_end"][j], out["pem_reg"][j],
                out["pem_cls"][j], max_proposals=top_k * 4)
            rows = soft_nms(rows, top_k=top_k)
            T = out["tem_start"].shape[1]
            rows[:, :2] = rows[:, :2] * b["duration"] / T
            gt[b["video"]] = b["segments"] * b["duration"]
            props[b["video"]] = rows
            total += len(rows)
    return _ar_report(gt, props, total, top_k)


def _ar_report(gt, props, total, max_avg) -> dict:
    _recall, avg_recall, _ppv, auc = average_recall_at_avg_proposals(
        gt, props, total_num_proposals=total, max_avg_proposals=max_avg)
    an = {f"AR@{n}": float(avg_recall[min(n, len(avg_recall)) - 1])
          for n in (1, 5, 10, 100)}
    return {"auc": float(auc), **an}


def _optimizer(cfg: Config):
    opt_name = (cfg.get("optimizer.optimizer", None)
                or cfg.get("optimizer.type", "adam")).lower()
    return make_loc_optimizer(
        opt_name, cfg.get("optimizer.learning_rate", 1e-3),
        cfg.get("optimizer.weight_decay", 0.0),
        cfg.get("optimizer.momentum", 0.9))


def _log_epoch(history, epoch, losses):
    rec = {"epoch": epoch, "loss": float(np.mean(losses))}
    history.append(rec)
    print(json.dumps(rec))


def train_from_config(cfg: Config, work_dir: str,
                      num_epochs: int | None = None, *, device=None,
                      draws: Optional[Draws] = None):
    """Trains the config's localizer on `device` (None: the CUDA device)
    and writes its final checkpoint under work_dir.  Returns (model,
    history, report)."""
    dev = resolve_device(device)
    no_tf32()
    mcfg = dict(cfg["model"])
    mtype = mcfg.pop("type", "BMN")
    bs = cfg.get("batch_size", 8)
    epochs = num_epochs or cfg.get("total_epochs", 9)
    tx = _optimizer(cfg)

    if mtype == "BMN":
        return _train_bmn(cfg, mcfg, work_dir, bs, tx, epochs, dev, draws)
    if mtype == "TEM":
        return _train_tem(cfg, mcfg, work_dir, bs, tx, epochs, dev)
    if mtype == "PEM":
        return _train_pem(cfg, mcfg, work_dir, bs, tx, epochs, dev, draws)
    if mtype == "SSN":
        return _train_ssn(cfg, mcfg, work_dir, bs, tx, epochs, dev)
    raise ValueError(f"unknown localization model type {mtype}")


def _train_bmn(cfg, mcfg, work_dir, bs, tx, epochs, dev, draws):
    bcfg = BMNConfig(**mcfg)
    model = _init(BMN(bcfg, device=dev))
    T = bcfg.temporal_dim
    train_ds = ActivityNetDataset(cfg["data.train.ann_file"],
                                  cfg["data.train.feature_prefix"], T)
    val_ds = ActivityNetDataset(cfg["data.val.ann_file"],
                                cfg["data.val.feature_prefix"], T)
    mask = torch.from_numpy(bm_mask(T, bcfg.max_duration)).to(dev)
    state = init_loc_state(model, tx)
    step = make_bmn_train_step(
        model, generator=torch.Generator().manual_seed(0), device=dev)
    history, n = [], 0
    for epoch in range(epochs):
        order = np.random.default_rng(epoch).permutation(len(train_ds))
        losses = []
        for batch, _n in _batches(train_ds, bs, order):
            labels = [bmn_labels(b["segments"], T, bcfg.max_duration)
                      for b in batch]
            gt_iou = _stack([l[0] for l in labels], dev)
            state, logs = step(
                state, _stack([b["features"] for b in batch], dev), gt_iou,
                _stack([l[1] for l in labels], dev),
                _stack([l[2] for l in labels], dev),
                mask.expand(gt_iou.shape),
                _draws_at(draws, n, gt_iou.shape))
            n += 1
            losses.append(float(logs["loss"]))
        _log_epoch(history, epoch, losses)
    report = evaluate_bmn_proposals(model, val_ds, bs, device=dev)
    save_checkpoint(os.path.join(work_dir, "bmn_final"),
                    localizer_variables_to_jax(model.state_dict()), bcfg,
                    report)
    print(json.dumps(report))
    return model, history, report


def _train_tem(cfg, mcfg, work_dir, bs, tx, epochs, dev):
    T = mcfg.get("temporal_dim", 100)
    model = _init(TEM(mcfg.get("feat_dim", 400), mcfg.get("hidden", 512),
                      device=dev))
    train_ds = ActivityNetDataset(cfg["data.train.ann_file"],
                                  cfg["data.train.feature_prefix"], T)
    state = init_loc_state(model, tx)
    step = make_bsn_tem_train_step(model, device=dev)
    history = []
    for epoch in range(epochs):
        losses = []
        for batch, _n in _batches(train_ds, bs):
            labels = [bsn_tem_labels(b["segments"], T) for b in batch]
            state, logs = step(
                state, _stack([b["features"] for b in batch], dev),
                *(_stack([l[i] for l in labels], dev) for i in range(3)))
            losses.append(float(logs["loss"]))
        _log_epoch(history, epoch, losses)
    save_checkpoint(os.path.join(work_dir, "tem_final"),
                    localizer_variables_to_jax(model.state_dict()), None, {})
    return model, history, {}


def load_pgm_videos(cfg: Config, split: str, top_k: int):
    """(video dicts, per-video LoadProposals results) for a split whose
    config block names ann_file + pgm_proposals_dir + pgm_features_dir
    (the bsn_pgm artifact layout)."""
    from ..data.pipelines_extra import LoadProposals

    ds = ActivityNetDataset(cfg[f"data.{split}.ann_file"],
                            feature_prefix="", temporal_dim=1)
    op = LoadProposals(
        top_k=top_k,
        pgm_proposals_dir=cfg[f"data.{split}.pgm_proposals_dir"],
        pgm_features_dir=cfg[f"data.{split}.pgm_features_dir"])
    return [(v, op({"video_name": v["video"]})) for v in ds.videos]


@torch.no_grad()
def evaluate_pem_proposals(model: PEM, videos, top_k: int, post_k: int,
                           device=None) -> dict:
    """AR@AN over the fused scores (pem * tmin_score * tmax_score) after
    soft-NMS (the reference's PEM forward_test, bsn.py:352-377); each
    video's features padded to top_k rows as the JAX CLI pads them."""
    dev = resolve_device(device)
    model.eval()
    gt, props, total = {}, {}, 0
    for v, r in videos:
        f = np.asarray(r["bsp_feature"], np.float32)
        n = len(f)
        pad = np.resize(np.arange(n), top_k)
        pred = model(torch.from_numpy(f[pad]).to(dev)).float().cpu(
            ).numpy()[:n]
        score = pred * r["tmin_score"][:n] * r["tmax_score"][:n]
        rows = np.stack([r["tmin"][:n], r["tmax"][:n], score], 1)
        rows = soft_nms(rows, top_k=post_k)
        rows[:, :2] = rows[:, :2] * v["duration"]
        gt[v["video"]] = v["segments"] * v["duration"]
        props[v["video"]] = rows
        total += len(rows)
    return _ar_report(gt, props, total, post_k)


def _train_pem(cfg, mcfg, work_dir, bs, tx, epochs, dev, draws):
    """BSN stage 3: train the PEM scorer on PGM proposal features, then
    AR@AN over score-fused + soft-NMS'd val proposals."""
    top_k = mcfg.get("top_k", 500)
    train = load_pgm_videos(cfg, "train", top_k)
    feats = np.concatenate([r["bsp_feature"] for _, r in train])
    gt_iou = np.concatenate([r["reference_temporal_iou"] for _, r in train])
    rows_per_step = bs * top_k
    model = _init(PEM(feats.shape[1], mcfg.get("hidden", 256),
                      mcfg.get("fc1_ratio", 0.1), mcfg.get("fc2_ratio", 0.1),
                      device=dev))
    state = init_loc_state(model, tx)
    step = make_bsn_pem_train_step(
        model, weighted=True,
        u_ratio_m=mcfg.get("u_ratio_m", 1.0),
        u_ratio_l=mcfg.get("u_ratio_l", 2.0),
        high_thr=mcfg.get("high_iou_threshold", 0.6),
        low_thr=mcfg.get("low_iou_threshold", 0.2),
        generator=torch.Generator().manual_seed(1), device=dev)
    history, n = [], 0
    for epoch in range(epochs):
        order = np.random.default_rng(epoch).permutation(len(feats))
        losses = []
        for i in range(0, len(order), rows_per_step):
            sel = order[i:i + rows_per_step]
            if len(sel) < rows_per_step:   # one shape: cycle rows
                sel = np.resize(sel, rows_per_step)
            state, logs = step(
                state, torch.from_numpy(feats[sel]).to(dev),
                torch.from_numpy(gt_iou[sel]).to(dev),
                _draws_at(draws, n, (rows_per_step,)))
            n += 1
            losses.append(float(logs["loss"]))
        _log_epoch(history, epoch, losses)
    report = evaluate_pem_proposals(model, load_pgm_videos(cfg, "val", top_k),
                                    top_k, mcfg.get("post_process_top_k",
                                                    100), dev)
    save_checkpoint(os.path.join(work_dir, "pem_final"),
                    localizer_variables_to_jax(model.state_dict()), None,
                    report)
    print(json.dumps(report))
    return model, history, report


def _resample_rows(feats: np.ndarray, T: int) -> np.ndarray:
    """Linear temporal resample of (t, F) snippet features to (T, F)
    (the ActivityNetDataset.features policy)."""
    if feats.shape[0] == T:
        return feats.astype(np.float32)
    pos = np.linspace(0, feats.shape[0] - 1, T)
    lo = np.floor(pos).astype(int)
    hi = np.minimum(lo + 1, feats.shape[0] - 1)
    frac = (pos - lo)[:, None]
    return ((1 - frac) * feats[lo] + frac * feats[hi]).astype(np.float32)


def _ssn_batch(ds, prefix, idxs, T, parts, dev):
    feats, stpps, labels, ptypes, targets = [], [], [], [], []
    for i in idxs:
        item = ds[int(i)]
        f = _resample_rows(
            np.load(os.path.join(prefix, item["video_id"] + ".npy")), T)
        scale = T / max(item["total_frames"], 1)
        props = np.asarray(item["sampled_proposals"], np.float64) * scale
        feats.append(f)
        stpps.append(stpp_matrix(T, props, parts))
        labels.append(item["labels"].astype(np.int64))
        ptypes.append(item["proposal_type"].astype(np.int64))
        targets.append(item["bbox_targets"])
    return tuple(_stack(a, dev)
                 for a in (feats, stpps, labels, ptypes, targets))


def _train_ssn(cfg, mcfg, work_dir, bs, tx, epochs, dev):
    """SSN over snippet features: the tag-style proposal file drives the
    positive/incomplete/background sampler; STPP pooling matrices are
    built host-side in snippet coordinates.  Reports the final loss and
    the positive proposals' activity accuracy on val."""
    T = mcfg.get("temporal_dim", 100)
    scfg = SSNSamplerConfig(**dict(cfg.get("sampler", {}) or {}))
    sscfg = SSNConfig(feat_dim=mcfg.get("feat_dim", 400),
                      num_classes=mcfg.get("num_classes", 20),
                      parts=tuple(mcfg.get("parts", (1, 2, 1))),
                      hidden=mcfg.get("hidden", 256))
    head = _init(SSNHead(sscfg, device=dev))
    lw = dict(cfg.get("ssn", {}) or {})
    state = init_loc_state(head, tx)
    step = make_ssn_batch_train_step(
        head, scfg, comp_loss_weight=lw.get("comp_loss_weight", 0.1),
        reg_loss_weight=lw.get("reg_loss_weight", 0.1), device=dev)
    train_ds = SSNDataset(cfg["data.train.ann_file"], sampler_cfg=scfg)
    train_prefix = cfg["data.train.feature_prefix"]
    history = []
    for epoch in range(epochs):
        order = np.random.default_rng(epoch).permutation(len(train_ds))
        losses = []
        for i in range(0, len(order), bs):
            sel = np.resize(order[i:i + bs], bs)   # one batch shape
            state, logs = step(state, *_ssn_batch(
                train_ds, train_prefix, sel, T, sscfg.parts, dev))
            losses.append(float(logs["loss"]))
        _log_epoch(history, epoch, losses)

    # val: positive-proposal activity accuracy over the sampled layout
    val_ds = SSNDataset(cfg["data.val.ann_file"], sampler_cfg=scfg, seed=1)
    val_prefix = cfg["data.val.feature_prefix"]
    head.eval()
    hits, n_pos = 0, 0
    for i in range(0, len(val_ds), bs):
        sel = np.resize(np.arange(i, min(i + bs, len(val_ds))), bs)
        n_real = min(bs, len(val_ds) - i)
        f, s, lab, pt, _tg = _ssn_batch(val_ds, val_prefix, sel, T,
                                        sscfg.parts, dev)
        with torch.no_grad():
            act = head(f, s)["activity"].cpu().numpy()[:n_real]
        lab_np, pt_np = lab.cpu().numpy()[:n_real], pt.cpu().numpy()[:n_real]
        pos = pt_np == 0
        hits += int((act.argmax(-1)[pos] == lab_np[pos]).sum())
        n_pos += int(pos.sum())
    report = {"pos_acc": hits / max(n_pos, 1),
              "final_loss": history[-1]["loss"]}
    save_checkpoint(os.path.join(work_dir, "ssn_final"),
                    localizer_variables_to_jax(head.state_dict()), sscfg,
                    report)
    print(json.dumps(report))
    return head, history, report


def load_localizer(path: str, kind: str, device=None) -> torch.nn.Module:
    """The model of a `*_final` checkpoint either package wrote: kind is
    'BMN', 'TEM', 'PEM' (fc ratios 0.1) or 'SSN'; widths from the
    checkpoint's config (BMN, SSN) or its kernels (TEM, PEM)."""
    variables, config, _meta = load_checkpoint(path)
    sd = localizer_state_dict_from_jax(variables)
    dev = resolve_device(device)
    if kind == "BMN":
        model = BMN(BMNConfig(**config), device=dev)
    elif kind == "SSN":
        model = SSNHead(SSNConfig(**dict(config,
                                         parts=tuple(config["parts"]))),
                        device=dev)
    elif kind == "TEM":
        hidden, feat_dim = sd["c1.weight"].shape[:2]
        model = TEM(feat_dim, hidden, device=dev)
    elif kind == "PEM":
        hidden, feat_dim = sd["fc1.weight"].shape
        model = PEM(feat_dim, hidden, device=dev)
    else:
        raise ValueError(f"unknown localization model type {kind}")
    model.load_state_dict(sd)
    return model.eval()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("config")
    parser.add_argument("--work_dir", required=True)
    parser.add_argument("--total_epochs", type=int, default=None)
    parser.add_argument("--cfg-options", nargs="*", default=[])
    parser.add_argument("--device", default=None,
                        help="default: the CUDA device")
    args = parser.parse_args(argv)
    cfg = Config.fromfile(args.config).merge_from_options(args.cfg_options)
    os.makedirs(args.work_dir, exist_ok=True)
    _, history, report = train_from_config(cfg, args.work_dir,
                                           args.total_epochs,
                                           device=args.device)
    return history, report


if __name__ == "__main__":
    main()
