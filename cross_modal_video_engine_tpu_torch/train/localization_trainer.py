"""Temporal-action-localization training (BMN, BSN, SSN).

Counterpart of cross_modal_video_engine_tpu/train/localization_trainer.py:
label generation on the host (numpy copies of `bm_mask`, `bmn_labels`,
`bsn_tem_labels`), the SSN proposal sampler (`sample_ssn_proposals`, its
`rng.choice` draws as numpy makes them), and one step maker per model over
`train/optim.OptaxOptimizer`.

Label semantics match the reference generators:
* BMN: gt_iou_map (D, T) is each (duration, start) anchor's largest
  temporal iou with the gt segments; gt_start/gt_end the largest
  intersection-over-anchor with a 3/T-wide window around each gt boundary
  (MCT/mmaction/models/localizers/bmn.py:139-175, 286-340);
* BSN TEM: action is the largest IoP of the one-snippet anchor with the
  gt segments; start/end windows are max(1/T, boundary_ratio*len) wide
  (localizers/bsn.py:163-207);
* SSN: proposals are bucketed positive / incomplete / background by
  (iou, overlap-self) thresholds and sampled to fixed per-video counts,
  so the loss sees a fixed layout (ssn_dataset.py's sampler).

A step updates the state's model and optimizer in place and returns the
state with its logs (detached 0-d tensors), as the JAX steps return their
new parameters and optimizer state.  The localization steps clip no
gradient (`make_loc_optimizer` passes max_norm=None).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..losses.localization import (bmn_loss, bsn_pem_loss,
                                   bsn_pem_weighted_loss, bsn_tem_loss,
                                   ssn_loss)
from ..metrics.proposals import pairwise_temporal_iou
from ..utils.device import resolve_device
from ..utils.precision import no_tf32
from .optim import OptaxOptimizer


# -- label generation (host side) ---------------------------------------------

def _iou_1d(amin, amax, gmin, gmax):
    inter = np.clip(np.minimum(amax[..., None], gmax)
                    - np.maximum(amin[..., None], gmin), 0, None)
    union = (amax - amin)[..., None] + (gmax - gmin) - inter
    return inter / np.maximum(union, 1e-9)


def _iop_1d(amin, amax, gmin, gmax):
    inter = np.clip(np.minimum(amax[..., None], gmax)
                    - np.maximum(amin[..., None], gmin), 0, None)
    return inter / np.maximum((amax - amin)[..., None], 1e-9)


def bm_mask(T: int, D: Optional[int] = None) -> np.ndarray:
    """(D, T) validity mask: duration-d anchors fit for the first T-d
    starts."""
    D = T if D is None else D
    return (np.arange(T)[None, :] < (T - np.arange(D))[:, None]).astype(
        np.float32)


def bmn_labels(gt_segments: np.ndarray, T: int, D: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """gt_segments: (n, 2) normalized [0,1] -> (gt_iou_map (D, T),
    gt_start (T,), gt_end (T,))."""
    D = T if D is None else D
    gap = 1.0 / T
    tmins = np.arange(T) * gap                       # (T,)
    durations = (np.arange(D) + 1) * gap             # (D,)
    amin = np.broadcast_to(tmins[None, :], (D, T))
    amax = amin + durations[:, None]
    gt = np.atleast_2d(np.asarray(gt_segments, np.float64))
    iou = _iou_1d(amin, amax, gt[:, 0], gt[:, 1])    # (D, T, n)
    gt_iou_map = iou.max(-1).astype(np.float32)

    pad = 3.0 * gap
    # boundary anchors are 2-gap wide: _temporal_anchors(-0.5, 1.5)
    # (bmn.py:134-135), i.e. [gap*(i-0.5), gap*(i+1.5)]
    anchors_min = gap * (np.arange(T) - 0.5)
    anchors_max = gap * (np.arange(T) + 1.5)
    start_lo, start_hi = gt[:, 0] - pad / 2, gt[:, 0] + pad / 2
    end_lo, end_hi = gt[:, 1] - pad / 2, gt[:, 1] + pad / 2
    gt_start = _iop_1d(anchors_min, anchors_max, start_lo, start_hi
                       ).max(-1).astype(np.float32)
    gt_end = _iop_1d(anchors_min, anchors_max, end_lo, end_hi
                     ).max(-1).astype(np.float32)
    return gt_iou_map, gt_start, gt_end


def bsn_tem_labels(gt_segments: np.ndarray, T: int,
                   boundary_ratio: float = 0.1
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(action, start, end) per-snippet match scores (T,) each."""
    gap = 1.0 / T
    amin = gap * np.arange(T)
    amax = amin + gap
    gt = np.atleast_2d(np.asarray(gt_segments, np.float64))
    lens = gt[:, 1] - gt[:, 0]
    pad = np.maximum(gap, boundary_ratio * lens)
    action = _iop_1d(amin, amax, gt[:, 0], gt[:, 1]).max(-1)
    start = _iop_1d(amin, amax, gt[:, 0] - pad / 2,
                    gt[:, 0] + pad / 2).max(-1)
    end = _iop_1d(amin, amax, gt[:, 1] - pad / 2,
                  gt[:, 1] + pad / 2).max(-1)
    return (action.astype(np.float32), start.astype(np.float32),
            end.astype(np.float32))


# -- SSN proposal sampler -----------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SSNSamplerConfig:
    positive_per_video: int = 1
    incomplete_per_video: int = 6
    background_per_video: int = 1
    positive_iou: float = 0.7
    background_iou: float = 0.01
    incomplete_iou: float = 0.3
    incomplete_overlap: float = 0.01
    # minimum fraction of the video a background proposal must span
    # (get_negatives background_coverage_threshold; 0.02 in the shipped
    # SSN configs)
    background_coverage: float = 0.01


def sample_ssn_proposals(proposals: np.ndarray, gt_segments: np.ndarray,
                         gt_labels: np.ndarray, cfg: SSNSamplerConfig,
                         rng: np.random.Generator
                         ) -> Dict[str, np.ndarray]:
    """Bucket proposals by (iou, overlap-self) and sample the fixed
    per-video layout [positives..., incompletes..., backgrounds...].

    proposals: (m, 2+) segments; gt_segments: (n, 2); gt_labels: (n,)
    1-based class ids.  Returns dict(proposals (P, 2), labels (P,),
    proposal_type (P,), bbox_targets (P, 2)); buckets are replicated when
    short (the reference sampler resamples too)."""
    iou = pairwise_temporal_iou(proposals[:, :2], gt_segments)     # (n, m)
    best_gt = iou.argmax(0)
    best_iou = iou.max(0)
    _, overlap = pairwise_temporal_iou(proposals[:, :2], gt_segments,
                                       calculate_overlap_self=True)
    best_overlap = overlap.max(0)

    pos = np.nonzero(best_iou >= cfg.positive_iou)[0]
    # get_negatives is if/elif: a proposal that qualifies as incomplete
    # is NEVER also background, and backgrounds must additionally cover
    # enough of the video (ssn_dataset.py:560-594)
    inc_mask = ((best_iou < cfg.incomplete_iou)
                & (best_overlap > cfg.incomplete_overlap))
    coverage = proposals[:, 1] - proposals[:, 0]
    inc = np.nonzero(inc_mask)[0]
    bg = np.nonzero(~inc_mask & (best_iou < cfg.background_iou)
                    & (coverage > cfg.background_coverage))[0]

    def pick(idx, k):
        if len(idx) == 0:
            idx = np.arange(len(proposals))
        return rng.choice(idx, size=k, replace=len(idx) < k)

    pos_i = pick(pos, cfg.positive_per_video)
    inc_i = pick(inc, cfg.incomplete_per_video)
    bg_i = pick(bg, cfg.background_per_video)
    order = np.concatenate([pos_i, inc_i, bg_i])

    segs = proposals[order, :2].astype(np.float32)
    labels = gt_labels[best_gt[order]].astype(np.int32)
    labels[len(pos_i) + len(inc_i):] = 0            # background class 0
    ptype = np.concatenate([
        np.zeros(len(pos_i)), np.ones(len(inc_i)),
        np.full(len(bg_i), 2)]).astype(np.int32)

    # regression targets (center offset / log-span) for positives vs their
    # best gt (SSN's location regression parameterization)
    g = gt_segments[best_gt[order]]
    p_ctr, p_len = segs.mean(1), np.maximum(segs[:, 1] - segs[:, 0], 1e-6)
    g_ctr, g_len = g.mean(1), np.maximum(g[:, 1] - g[:, 0], 1e-6)
    targets = np.stack([(g_ctr - p_ctr) / p_len,
                        np.log(g_len / p_len)], 1).astype(np.float32)
    return {"proposals": segs, "labels": labels, "proposal_type": ptype,
            "bbox_targets": targets}


# -- optimizer and state ------------------------------------------------------

class LocTrainState(NamedTuple):
    model: torch.nn.Module           # the f32 parameters
    optimizer: OptaxOptimizer        # count and moments


def make_loc_optimizer(name: str, lr: float, weight_decay: float = 0.0,
                       momentum: float = 0.9
                       ) -> Callable[..., OptaxOptimizer]:
    """named_params -> the OptaxOptimizer of the JAX localization CLI's
    chain (localization_train.py:107-117), with no gradient clip: 'sgd'
    is add_decayed_weights(wd) then sgd(lr, momentum); 'adamw' is
    adamw(lr, weight_decay=wd), wd 0 where the config names none; any
    other name is adam(lr), which takes no weight decay (the JAX CLI
    ignores the config's)."""
    name = name.lower()
    if name == "sgd":
        return functools.partial(OptaxOptimizer, lr=lr, kind="sgd",
                                 max_norm=None, weight_decay=weight_decay,
                                 momentum=momentum)
    if name == "adamw":
        return functools.partial(OptaxOptimizer, lr=lr, kind="adamw",
                                 max_norm=None, weight_decay=weight_decay)
    return functools.partial(OptaxOptimizer, lr=lr, kind="adam",
                             max_norm=None)


def init_loc_state(model: torch.nn.Module, tx) -> LocTrainState:
    """The state at step 0: tx (make_loc_optimizer's factory) over the
    model's parameters."""
    return LocTrainState(model, tx(list(model.named_parameters())))


def _prepare(model: torch.nn.Module, device) -> None:
    dev = resolve_device(device)
    at = next(model.parameters()).device
    if at.type != dev.type or (dev.index is not None
                               and at.index != dev.index):
        raise ValueError(f"the model is on {at}, the step was asked to run "
                         f"on {dev}")
    no_tf32()


def _apply(model, loss_fn):
    """The step around loss_fn(net, *batch) -> (loss, logs)."""
    def step(state: LocTrainState, *batch, **kw):
        net, opt = state
        if net is not model:
            raise ValueError("the state's model is not the one the step "
                             "was made for")
        net.train()
        opt.zero_grad(set_to_none=True)
        loss, logs = loss_fn(net, *batch, **kw)
        loss.backward()
        opt.step()
        return state, {k: v.detach() for k, v in logs.items()}

    return step


# -- train steps --------------------------------------------------------------

def make_bmn_train_step(model, generator: Optional[torch.Generator] = None,
                        device=None):
    """step(state, feats, gt_iou_map, gt_start, gt_end, mask, draws=None)
    -> (state, {"loss", "tem", "pem_reg", "pem_cls"}) on `device` (None:
    the CUDA device), where the model must lie.  draws: the PEM
    regression loss's two uniforms (B, D, T), else drawn from
    `generator` on the CPU."""
    _prepare(model, device)

    def loss_fn(net, feats, gt_iou_map, gt_start, gt_end, mask,
                draws=None):
        out = net(feats)
        total, tem, reg, cls = bmn_loss(
            out["pem_reg"], out["pem_cls"], out["tem_start"],
            out["tem_end"], gt_iou_map, gt_start, gt_end, mask, draws,
            generator)
        return total, {"loss": total, "tem": tem, "pem_reg": reg,
                       "pem_cls": cls}

    return _apply(model, loss_fn)


def make_bsn_tem_train_step(tem, action_loss_weight: float = 2.0,
                            device=None):
    """step(state, feats, gt_action, gt_start, gt_end) -> (state, the
    bsn_tem_loss dict)."""
    _prepare(tem, device)

    def loss_fn(net, feats, gt_action, gt_start, gt_end):
        out = net(feats)
        d = bsn_tem_loss(out["action"], out["start"], out["end"],
                         gt_action, gt_start, gt_end, action_loss_weight)
        return d["loss"], d

    return _apply(tem, loss_fn)


def make_bsn_pem_train_step(pem, *, weighted: bool = False,
                            u_ratio_m: float = 1.0, u_ratio_l: float = 2.0,
                            high_thr: float = 0.6, low_thr: float = 0.2,
                            generator: Optional[torch.Generator] = None,
                            device=None):
    """step(state, feats, gt_iou, draws=None) -> (state, {"loss"}).
    weighted=True uses the reference's u-mask balanced loss
    (bsn.py:313-349), its two uniforms handed in as draws or drawn from
    `generator`."""
    _prepare(pem, device)

    def loss_fn(net, feats, gt_iou, draws=None):
        pred = net(feats)
        if weighted:
            loss = bsn_pem_weighted_loss(pred, gt_iou, draws, generator,
                                         u_ratio_m, u_ratio_l, high_thr,
                                         low_thr)
        else:
            loss = bsn_pem_loss(pred, gt_iou)
        return loss, {"loss": loss}

    return _apply(pem, loss_fn)


def _ssn_losses(out, labels, ptype, targets, sc: SSNSamplerConfig,
                comp_loss_weight: float, reg_loss_weight: float) -> Dict:
    b, p = labels.shape
    act = out["activity"].reshape(b * p, -1)
    comp = out["completeness"].reshape(b * p, -1)
    reg = out["regression"].reshape(b * p, comp.shape[-1], 2)
    return ssn_loss(act, comp, reg, ptype.reshape(-1), labels.reshape(-1),
                    targets.reshape(b * p, 2), sc.positive_per_video,
                    sc.background_per_video, sc.incomplete_per_video,
                    comp_loss_weight, reg_loss_weight)


def make_ssn_train_step(head, sampler_cfg: SSNSamplerConfig,
                        comp_loss_weight: float = 0.1,
                        reg_loss_weight: float = 0.1, device=None):
    """step(state, features (T, F), stpp (P, S, T), labels (P,),
    proposal_type (P,), bbox_targets (P, 2)) -> (state, the ssn_loss
    dict): one video."""
    batch_step = make_ssn_batch_train_step(head, sampler_cfg,
                                           comp_loss_weight,
                                           reg_loss_weight, device)

    def step(state, features, stpp, labels, ptype, targets):
        return batch_step(state, features[None], stpp[None], labels[None],
                          ptype[None], targets[None])

    return step


def make_ssn_batch_train_step(head, sampler_cfg: SSNSamplerConfig,
                              comp_loss_weight: float = 0.1,
                              reg_loss_weight: float = 0.1, device=None):
    """Batched SSN step: features (B, T, F), stpp (B, P, S, T), labels /
    proposal_type (B, P), bbox_targets (B, P, 2).  The flattened (B*P)
    rows keep the per-video [positives..., incompletes...,
    backgrounds...] grouping ssn_loss's indexers require."""
    _prepare(head, device)

    def loss_fn(net, features, stpp, labels, ptype, targets):
        losses = _ssn_losses(net(features, stpp), labels, ptype, targets,
                             sampler_cfg, comp_loss_weight, reg_loss_weight)
        return losses["loss"], losses

    return _apply(head, loss_fn)
