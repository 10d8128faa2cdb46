"""AVA spatio-temporal action-detection training (FastRCNN-equivalent).

Counterpart of cross_modal_video_engine_tpu/train/detection_trainer.py
(mmdet's FastRCNN over a ResNet3dSlowOnly or SlowFast backbone with the
AVA RoI head, configs/detection/{ava,acrn,lfb}/):

* `AVAFastRCNN`: the backbone's last stage map (`return_stages=True`)
  into `models/ava_head.AVARoIHead`, with ACRNHead or FBOHead as the
  shared head (FBO takes the sampled long-term window as `lt_feat`).  The
  parameters sit as the JAX tree has them: `backbone`, `roi_head.fc_cls`
  and, beside them, `shared_head` (convert/from_jax.py's
  `ava_detector_*`).
* `_iou_xyxy`, `assign_proposals` (MaxIoUAssignerAVA pos_iou_thr with the
  GT boxes added as proposals) and `pack_detection_batch` (`max_boxes`
  RoIs a keyframe, zero-padded and masked by `valid`, so every step has
  one shape): numpy copies.
* `make_det_train_step`: train-mode BatchNorm (the statistics move in
  place), the multilabel BCE over the valid rows and `label_acc` (the
  share of classes 1.. whose sigmoid > 0.5 agrees with the label), over
  train/recognition_trainer's `RecTrainState` and `make_rec_optimizer`.
  The dropout masks come from the step's generator, or are handed in
  (`draws=`, one keep mask per dropout call in call order: the FBO's st,
  lt and layer outputs, then the head's).
* `make_det_infer`, `make_st_feature_fn`, `build_lfb` (the bank-building
  pass: the st features of the valid rows, keyed by video and second),
  `sample_lt_features` (each keyframe's window repeated for its
  `max_boxes` RoIs, zero for unknown videos and padded keyframes; the
  tensor stays on the bank's device), `detection_results` and
  `evaluate_ava_detection` (frame-mAP@0.5 through metrics/ava.py, boxes
  as [y1, x1, y2, x2]).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..metrics.ava import ava_frame_map, make_image_key
from ..models.ava_head import (AVAHeadConfig, AVARoIHead, ava_bbox_loss,
                               roi_align_maps)
from ..models.layers import Dropout
from .recognition_trainer import RecTrainState, _prepare


class AVAFastRCNN(nn.Module):
    """Backbone feature maps -> RoI head logits.  shared_head: None, or
    an ACRNHead or FBOHead built for the backbone's width
    (`backbone.feat_dim`, which flax reads off the map)."""

    def __init__(self, backbone: nn.Module, head_cfg: AVAHeadConfig,
                 shared_head: Optional[nn.Module] = None, device=None):
        super().__init__()
        self.backbone = backbone
        self.head_cfg = head_cfg
        self.roi_head = AVARoIHead(head_cfg, shared_head,
                                   in_channels=backbone.feat_dim,
                                   device=device)

    @property
    def shared_head(self) -> Optional[nn.Module]:
        return self.roi_head.shared_head

    def maps(self, clips: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, 3) -> the last stage's (B, T', H', W', C) map."""
        return self.backbone(clips, return_stages=True)[-1]

    def forward(self, clips: torch.Tensor, rois: torch.Tensor, *,
                lt_feat: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.roi_head(self.maps(clips), rois, lt_feat=lt_feat)


# -- host-side proposal assignment and static batch packing -------------------

def _iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of [x1,y1,x2,y2] boxes."""
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * \
        np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * \
        np.clip(b[:, 3] - b[:, 1], 0, None)
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    union = area_a[:, None] + area_b[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union > 0, inter / union, 0.0)


def assign_proposals(proposals: np.ndarray, gt_boxes: np.ndarray,
                     gt_labels: np.ndarray, num_classes: int,
                     pos_iou_thr: float = 0.9,
                     add_gt_as_proposals: bool = True):
    """MaxIoUAssignerAVA + RandomSampler(add_gt_as_proposals): proposals
    (P, 4) and gt_boxes (G, 4) normalized x1y1x2y2, gt_labels (G,
    num_classes) many-hot -> (boxes (N, 4), labels (N, num_classes)), the
    GT rows first; a proposal whose argmax-IoU GT reaches pos_iou_thr
    carries that GT's labels, the others an all-zero row."""
    proposals = np.asarray(proposals, np.float32).reshape(-1, 4)
    gt_boxes = np.asarray(gt_boxes, np.float32).reshape(-1, 4)
    gt_labels = np.asarray(gt_labels, np.float32).reshape(-1, num_classes)
    rows_b: List[np.ndarray] = []
    rows_l: List[np.ndarray] = []
    if add_gt_as_proposals and len(gt_boxes):
        rows_b.append(gt_boxes)
        rows_l.append(gt_labels)
    if len(proposals):
        lab = np.zeros((len(proposals), num_classes), np.float32)
        if len(gt_boxes):
            iou = _iou_xyxy(proposals, gt_boxes)
            best = iou.argmax(axis=1)
            pos = iou[np.arange(len(proposals)), best] >= pos_iou_thr
            lab[pos] = gt_labels[best[pos]]
        rows_b.append(proposals)
        rows_l.append(lab)
    if not rows_b:
        return (np.zeros((0, 4), np.float32),
                np.zeros((0, num_classes), np.float32))
    return np.concatenate(rows_b), np.concatenate(rows_l)


def pack_detection_batch(items: Sequence[Dict], max_boxes: int,
                         num_classes: int):
    """items: dicts with 'clip' (T, H, W, 3), 'boxes' (n, 4) normalized
    x1y1x2y2, 'labels' (n, num_classes) -> (clips (B, T, H, W, 3), rois
    (B * max_boxes, 5), labels, valid), numpy f32."""
    clips = np.stack([np.asarray(it["clip"], np.float32) for it in items])
    B = len(items)
    rois = np.zeros((B * max_boxes, 5), np.float32)
    labels = np.zeros((B * max_boxes, num_classes), np.float32)
    valid = np.zeros((B * max_boxes,), np.float32)
    for b, it in enumerate(items):
        boxes = np.asarray(it["boxes"], np.float32).reshape(-1, 4)
        labs = np.asarray(it["labels"], np.float32).reshape(-1, num_classes)
        n = min(len(boxes), max_boxes)
        sl = slice(b * max_boxes, b * max_boxes + n)
        rois[sl, 0] = b
        rois[sl, 1:] = boxes[:n]
        labels[sl] = labs[:n]
        valid[sl] = 1.0
    return clips, rois, labels, valid


# -- the train step -------------------------------------------------------------

def _on(device, *arrays):
    return [None if a is None else torch.as_tensor(a).to(device)
            for a in arrays]


@contextlib.contextmanager
def handed_masks(model: nn.Module, draws: Optional[Sequence]):
    """Every dropout of the model takes the next of `draws` (keep masks,
    in call order) while the context lasts; None leaves them drawing."""
    if draws is None:
        yield
        return
    masks = iter(draws)
    drops = [m for m in model.modules() if isinstance(m, Dropout)]
    for m in drops:
        m.masks = masks
    try:
        yield
    finally:
        for m in drops:
            m.masks = None
    if next(masks, None) is not None:
        raise ValueError("more dropout masks were handed in than drawn")


def label_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """The share of classes 1.. where sigmoid > 0.5 agrees with the label,
    averaged over the valid rows."""
    hit = ((torch.sigmoid(logits[:, 1:]) > 0.5)
           == (labels[:, 1:] > 0.5)).float().mean(-1)
    return (hit * valid).sum() / torch.clamp_min(valid.sum(), 1.0)


def make_det_train_step(model: AVAFastRCNN,
                        generator: Optional[torch.Generator] = None,
                        device=None):
    """step(state, clips, rois, labels, valid, lt_feat=None, draws=None) ->
    (state, {"loss", "label_acc"}): one forward in train mode (the
    BatchNorm statistics move in place), backward and optimizer step on
    `device` (None: the CUDA device), where the model must lie; f32 with
    TF32 off.  Inputs may be numpy arrays; logs are detached 0-d
    tensors."""
    _prepare(model, generator, device)
    dev = next(model.parameters()).device

    def step(state: RecTrainState, clips, rois, labels, valid, lt_feat=None,
             draws=None):
        net, opt = state.model, state.optimizer
        if net is not model:
            raise ValueError("the state's model is not the one the step "
                             "was made for")
        clips, rois, labels, valid, lt_feat = _on(dev, clips, rois, labels,
                                                  valid, lt_feat)
        net.train()
        opt.zero_grad(set_to_none=True)
        with handed_masks(net, draws):
            logits = net(clips, rois, lt_feat=lt_feat)
        loss = ava_bbox_loss(logits, labels, valid)
        acc = label_accuracy(logits.detach(), labels, valid)
        loss.backward()
        opt.step()
        return (state._replace(step=state.step + 1),
                {"loss": loss.detach(), "label_acc": acc})

    return step


def make_det_infer(model: AVAFastRCNN):
    """infer(clips, rois, lt_feat=None) -> sigmoid action scores per RoI,
    in eval mode (running statistics), without a graph."""
    dev = next(model.parameters()).device

    @torch.no_grad()
    def infer(clips, rois, lt_feat=None):
        model.eval()
        clips, rois, lt_feat = _on(dev, clips, rois, lt_feat)
        return torch.sigmoid(model(clips, rois, lt_feat=lt_feat))

    return infer


# -- the long-term feature bank's construction ----------------------------------

def make_st_feature_fn(model: AVAFastRCNN):
    """fn(clips, rois) -> the short-term RoI features (N, C) the bank
    stores (lfb_infer_head.py:75-88): the backbone's map, RoIAlign,
    temporal and spatial pools, in eval mode without a graph."""
    cfg = model.head_cfg
    dev = next(model.parameters()).device

    @torch.no_grad()
    def fn(clips, rois):
        model.eval()
        clips, rois = _on(dev, clips, rois)
        feats = model.maps(clips)
        maps = feats.mean(1) if cfg.temporal_pool == "avg" \
            else feats.amax(1)
        pooled = roi_align_maps(maps, rois, cfg.roi_size, cfg.sampling_ratio)
        return pooled.amax((1, 2)) if cfg.spatial_pool == "max" \
            else pooled.mean((1, 2))

    return fn


def build_lfb(model: AVAFastRCNN, batches: Iterable[Dict],
              capacity: int = 5, seed: int = 0):
    """The bank-building pass over keyframe batches with their meta
    ('video_id', 'timestamp'): each keyframe's valid rows' st features,
    built into a LongTermFeatureBank on the model's device."""
    from ..models.lfb import LFBBuilder
    fn = make_st_feature_fn(model)
    builder: Optional[LFBBuilder] = None
    for batch in batches:
        st = fn(batch["clips"], batch["rois"]).cpu().numpy()
        if builder is None:
            builder = LFBBuilder(st.shape[-1], capacity)
        max_boxes = batch["rois"].shape[0] // batch["clips"].shape[0]
        for b in range(len(batch["video_id"])):
            sl = slice(b * max_boxes, (b + 1) * max_boxes)
            n = int(np.asarray(batch["valid"][sl]).sum())
            if n:
                builder.add(batch["video_id"][b], batch["timestamp"][b],
                            st[sl][:n])
    if builder is None:
        raise ValueError("no batches to build LFB from")
    return builder.build(seed, device=next(model.parameters()).device)


def sample_lt_features(bank, video_ids: Sequence[str], timestamps: Sequence,
                       max_boxes: int, window_size: int = 60,
                       batch_size: Optional[int] = None) -> torch.Tensor:
    """(B * max_boxes, window * capacity, C) on the bank's device: each
    keyframe's window repeated for its max_boxes RoIs; an unknown video's
    window and the padded tail keyframes' rows (batch_size >
    len(video_ids)) are zero."""
    vidx = np.asarray([bank.video_index.get(v, -1) for v in video_ids])
    ts = np.asarray([int(t) for t in timestamps])
    lt = bank.sample_batch(np.maximum(vidx, 0), ts, window_size)
    known = torch.as_tensor(vidx >= 0, device=lt.device)
    lt = torch.where(known[:, None, None], lt, 0.0)
    lt = lt.repeat_interleave(max_boxes, 0)
    B = batch_size or len(video_ids)
    if B > len(video_ids):
        lt = torch.cat([lt, lt.new_zeros(((B - len(video_ids)) * max_boxes,)
                                         + lt.shape[1:])])
    return lt


# -- AVA-protocol evaluation ------------------------------------------------------

def detection_results(scores, boxes, n_valid: int, num_classes: int,
                      action_thr: float = 0.002) -> List[np.ndarray]:
    """A keyframe's sigmoid scores (N, num_classes) and boxes (N, 4) -> the
    reference's per-class result list (entry l - 1 holds action l): each
    (k, 5) [x1, y1, x2, y2, score] with score >= action_thr."""
    out: List[np.ndarray] = []
    boxes = np.asarray(boxes)[:n_valid]
    scores = np.asarray(scores)[:n_valid]
    for c in range(1, num_classes):
        keep = scores[:, c] >= action_thr
        out.append(np.concatenate(
            [boxes[keep], scores[keep, c:c + 1]], axis=1)
            if keep.any() else np.zeros((0, 5), np.float32))
    return out


def evaluate_ava_detection(infer, batches: Iterable[Dict], num_classes: int,
                           action_thr: float = 0.002, bank=None,
                           window_size: int = 60) -> Dict[str, float]:
    """Inference over val keyframe batches (clips/rois/valid packed, with
    'video_id', 'timestamp', 'gt_boxes', 'gt_labels' lists) scored by
    frame-mAP@0.5; returns ava_frame_map's dict plus 'mAP@0.5IOU'."""
    det_boxes: Dict[str, List] = {}
    det_labels: Dict[str, List] = {}
    det_scores: Dict[str, List] = {}
    gt_boxes_d: Dict[str, List] = {}
    gt_labels_d: Dict[str, List] = {}
    for batch in batches:
        n_clips = batch["clips"].shape[0]
        max_boxes = batch["rois"].shape[0] // n_clips
        lt = None
        if bank is not None:
            lt = sample_lt_features(bank, batch["video_id"],
                                    batch["timestamp"], max_boxes,
                                    window_size, n_clips)
        scores = infer(batch["clips"], batch["rois"], lt).cpu().numpy()
        rois = np.asarray(batch["rois"])
        for b in range(min(n_clips, len(batch["video_id"]))):
            key = make_image_key(batch["video_id"][b], batch["timestamp"][b])
            sl = slice(b * max_boxes, (b + 1) * max_boxes)
            n = int(np.asarray(batch["valid"][sl]).sum())
            db = det_boxes.setdefault(key, [])
            dl = det_labels.setdefault(key, [])
            ds = det_scores.setdefault(key, [])
            per_class = detection_results(scores[sl], rois[sl][:, 1:], n,
                                          num_classes, action_thr)
            for c, dets in enumerate(per_class, start=1):
                for x1, y1, x2, y2, s in dets:
                    db.append([y1, x1, y2, x2])   # AVA eval convention
                    dl.append(c)
                    ds.append(float(s))
            gb = gt_boxes_d.setdefault(key, [])
            gl = gt_labels_d.setdefault(key, [])
            for i, box in enumerate(np.asarray(
                    batch["gt_boxes"][b]).reshape(-1, 4)):
                labs = np.nonzero(np.asarray(batch["gt_labels"][b]).reshape(
                    -1, num_classes)[i] > 0.5)[0]
                for c in labs:
                    if c == 0:
                        continue
                    x1, y1, x2, y2 = box
                    gb.append([y1, x1, y2, x2])
                    gl.append(int(c))
    metrics = ava_frame_map(gt_boxes_d, gt_labels_d, det_boxes, det_labels,
                            det_scores, class_ids=range(1, num_classes))
    metrics["mAP@0.5IOU"] = metrics["PascalBoxes_Precision/mAP@0.5IOU"]
    return metrics
