"""The YOLOv5 training criterion, with the JAX package's static shapes.

Counterpart of cross_modal_video_engine_tpu/losses/yolo.py
(MCT/yolov5/utils/loss.py ComputeLoss and build_targets, CIoU from
utils/metrics.py bbox_iou, the segment criterion of
utils/segment/loss.py).  The assignment keeps the JAX package's dense
candidate layout: every (offset, anchor, target slot) triple is a
candidate, flattened (5 offsets, na, B*T), with a validity mask; the
box, class and mask terms are masked means over it.  The mask cap of the
segmentation loss keeps the first `mask_cap` valid candidates of an image
in that order (a stable sort), so the layout is part of the result.

Semantics the JAX module fixes and this copy keeps:

* anchor match max(wh/anchor, anchor/wh) < anchor_t; the neighbour cells
  whose fractional centre coordinate is < 0.5;
* `tbox` xy relative to the clamped cell;
* the objectness target is the detached, clamped CIoU, and a cell that
  several candidates own takes the largest (`scatter_reduce("amax")`);
* the class loss only when num_classes > 1, against label-smoothed
  one-hot targets;
* objectness balanced (4.0, 1.0, 0.4) over P3-P5; `total` is
  (box + obj + cls [+ seg]) * B, the seg gain hyp.box / B.

Targets arrive padded per image: (B, T, 5) rows [class, cx, cy, w, h]
normalized, with a (B, T) validity mask.  Raw maps are channels-last
(B, H, W, na*no), anchor outer within the channel axis, as models/yolo.py
returns them.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F


class YoloHyp(NamedTuple):
    """The loss gains of hyp.scratch-low.yaml, after `scale_hyp`."""
    box: float = 0.05
    cls: float = 0.5
    obj: float = 1.0
    cls_pw: float = 1.0
    obj_pw: float = 1.0
    anchor_t: float = 4.0
    label_smoothing: float = 0.0


def scale_hyp(hyp: YoloHyp, *, nl: int, nc: int, imgsz: int) -> YoloHyp:
    """train.py:233-237: the gains scaled to layers, classes, resolution."""
    return hyp._replace(
        box=hyp.box * 3.0 / nl,
        cls=hyp.cls * nc / 80.0 * 3.0 / nl,
        obj=hyp.obj * (imgsz / 640.0) ** 2 * 3.0 / nl,
    )


def smooth_bce(eps: float = 0.1) -> Tuple[float, float]:
    """The positive and negative label-smoothed BCE targets."""
    return 1.0 - 0.5 * eps, 0.5 * eps


def bbox_ciou(box1: torch.Tensor, box2: torch.Tensor,
              eps: float = 1e-7) -> torch.Tensor:
    """Complete IoU of (..., 4) centre-size boxes (broadcasting)."""
    x1, y1, w1, h1 = box1.unbind(-1)
    x2, y2, w2, h2 = box2.unbind(-1)
    b1x1, b1x2 = x1 - w1 / 2, x1 + w1 / 2
    b1y1, b1y2 = y1 - h1 / 2, y1 + h1 / 2
    b2x1, b2x2 = x2 - w2 / 2, x2 + w2 / 2
    b2y1, b2y2 = y2 - h2 / 2, y2 + h2 / 2
    inter = ((torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1))
             .clamp(min=0)
             * (torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1))
             .clamp(min=0))
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = ((b2x1 + b2x2 - b1x1 - b1x2) ** 2
            + (b2y1 + b2y2 - b1y1 - b1y2) ** 2) / 4.0
    v = (4.0 / math.pi ** 2) * (torch.atan(w2 / (h2 + eps))
                                - torch.atan(w1 / (h1 + eps))) ** 2
    alpha = (v / (v - iou + (1.0 + eps))).detach()
    return iou - (rho2 / c2 + v * alpha)


def _bce_logits(logits: torch.Tensor, targets: torch.Tensor,
                pos_weight: float) -> torch.Tensor:
    """Elementwise nn.BCEWithLogitsLoss(pos_weight=...)."""
    return -(pos_weight * targets * F.logsigmoid(logits)
             + (1.0 - targets) * F.logsigmoid(-logits))


class LayerTargets(NamedTuple):
    """One layer's dense assignment, K = 5 offsets * na * B*T."""
    b: torch.Tensor        # (K,) image index
    a: torch.Tensor        # (K,) anchor index
    gj: torch.Tensor       # (K,) grid row (clamped)
    gi: torch.Tensor       # (K,) grid column (clamped)
    tbox: torch.Tensor     # (K, 4) cell-relative xy, grid-unit wh
    tcls: torch.Tensor     # (K,) class index
    anch: torch.Tensor     # (K, 2) the anchor's wh (grid units)
    mask: torch.Tensor     # (K,) bool validity


_OFFSETS = ((0.0, 0.0), (1.0, 0.0), (0.0, 1.0), (-1.0, 0.0), (0.0, -1.0))


def build_targets(targets: torch.Tensor, valid: torch.Tensor,
                  anchors: Sequence[Sequence[Tuple[float, float]]],
                  strides: Sequence[int],
                  grid_shapes: Sequence[Tuple[int, int]],
                  anchor_t: float = 4.0) -> List[LayerTargets]:
    """targets (B, T, 5) normalized, valid (B, T) bool, anchors per layer
    (na, 2) in pixels (divided by the stride here), grid_shapes per
    layer (H, W)."""
    B, T, _ = targets.shape
    dev = targets.device
    nt = B * T
    flat = targets.reshape(nt, 5).float()
    bidx = torch.arange(B, device=dev).repeat_interleave(T)
    vflat = valid.reshape(nt)
    offsets = torch.tensor(_OFFSETS, dtype=torch.float32, device=dev)
    g = 0.5
    out: List[LayerTargets] = []
    for anc, stride, (H, W) in zip(anchors, strides, grid_shapes):
        anc = torch.tensor(anc, dtype=torch.float32, device=dev) / float(
            stride)                                             # (na, 2)
        na = anc.shape[0]
        gain = torch.tensor([W, H], dtype=torch.float32, device=dev)
        gxy = flat[:, 1:3] * gain                               # (nt, 2)
        gwh = flat[:, 3:5] * gain
        r = gwh[None] / anc[:, None]                            # (na, nt, 2)
        amatch = torch.maximum(r, 1.0 / r).amax(-1) < anchor_t
        jk = (torch.remainder(gxy, 1.0) < g) & (gxy > 1.0)
        inv = gain - gxy
        lm = (torch.remainder(inv, 1.0) < g) & (inv > 1.0)
        off_ok = torch.stack([torch.ones_like(jk[:, 0]), jk[:, 0], jk[:, 1],
                              lm[:, 0], lm[:, 1]])              # (5, nt)
        mask = vflat[None, None] & amatch[None] & off_ok[:, None]
        gij = torch.floor(gxy[None] - offsets[:, None] * g)     # (5, nt, 2)
        gi = gij[..., 0].long().clamp(0, W - 1)
        gj = gij[..., 1].long().clamp(0, H - 1)
        txy = gxy[None] - torch.stack([gi, gj], -1).float()     # (5, nt, 2)
        K = 5 * na * nt

        def bcast(x, trailing=()):
            return x.expand((5, na, nt) + trailing).reshape((K,) + trailing)

        out.append(LayerTargets(
            b=bcast(bidx[None, None]),
            a=bcast(torch.arange(na, device=dev)[None, :, None]),
            gj=bcast(gj[:, None]),
            gi=bcast(gi[:, None]),
            tbox=torch.cat([txy[:, None].expand(5, na, nt, 2),
                            gwh[None, None].expand(5, na, nt, 2)],
                           -1).reshape(K, 4),
            tcls=bcast(flat[None, None, :, 0].long()),
            anch=bcast(anc[None, :, None], (2,)),
            mask=mask.reshape(K)))
    return out


BALANCE3 = (4.0, 1.0, 0.4)   # P3-P5 objectness balance (loss.py:112)


def yolo_loss(raw_maps: Sequence[torch.Tensor], targets: torch.Tensor,
              valid: torch.Tensor,
              anchors: Sequence[Sequence[Tuple[float, float]]],
              strides: Sequence[int] = (8, 16, 32),
              hyp: YoloHyp = YoloHyp(), num_classes: int = 80
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """ComputeLoss: (total, {"box", "obj", "cls"}), total = (box + obj +
    cls) * B."""
    return _yolo_loss_impl(raw_maps, targets, valid, anchors, strides, hyp,
                           num_classes)


def yolo_seg_loss(raw_maps: Sequence[torch.Tensor], proto: torch.Tensor,
                  targets: torch.Tensor, valid: torch.Tensor,
                  gt_masks: torch.Tensor,
                  anchors: Sequence[Sequence[Tuple[float, float]]],
                  strides: Sequence[int] = (8, 16, 32),
                  hyp: YoloHyp = YoloHyp(), num_classes: int = 80,
                  nm: int = 32, mask_cap: int = 128
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The segment criterion (non-overlap masks): the detection terms over
    maps of 5+nc+nm channels per anchor, plus the prototype-mask BCE
    cropped to each target's box (`_layer_mask_loss`), gain hyp.box / B.
    proto (B, Hm, Wm, nm); gt_masks (B, T, Hm, Wm).  items["seg_dropped"]
    counts the valid candidates past `mask_cap`."""
    return _yolo_loss_impl(raw_maps, targets, valid, anchors, strides, hyp,
                           num_classes, proto=proto, gt_masks=gt_masks,
                           nm=nm, mask_cap=mask_cap)


def _yolo_loss_impl(raw_maps, targets, valid, anchors, strides, hyp,
                    num_classes, proto=None, gt_masks=None, nm=0,
                    mask_cap=0):
    nc = num_classes
    cp, cn = smooth_bce(hyp.label_smoothing)
    B, T, _ = targets.shape
    dev = targets.device
    tl = build_targets(targets, valid, anchors, strides,
                       [(m.shape[1], m.shape[2]) for m in raw_maps],
                       hyp.anchor_t)
    seg = proto is not None
    no = 5 + nc + (nm if seg else 0)
    zero = torch.zeros((), device=dev)
    lbox, lobj, lcls, lseg = zero, zero, zero, zero
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    for i, (pi, t) in enumerate(zip(raw_maps, tl)):
        Bi, H, W, _ = pi.shape
        pi = pi.reshape(Bi, H, W, -1, no)                     # (B,H,W,na,no)
        na = pi.shape[3]
        pred = pi[t.b, t.gj, t.gi, t.a]                       # (K, no)
        m = t.mask.to(pred.dtype)
        n = m.sum().clamp(min=1.0)

        pxy = torch.sigmoid(pred[:, :2]) * 2.0 - 0.5
        pwh = (torch.sigmoid(pred[:, 2:4]) * 2.0) ** 2 * t.anch
        iou = bbox_ciou(torch.cat([pxy, pwh], -1), t.tbox)    # (K,)
        lbox = lbox + ((1.0 - iou) * m).sum() / n

        iou_det = iou.detach().clamp(min=0.0) * m
        flat_idx = ((t.b * H + t.gj) * W + t.gi) * na + t.a
        tobj = torch.zeros(Bi * H * W * na, dtype=pred.dtype, device=dev)
        tobj = tobj.scatter_reduce(0, flat_idx, iou_det, "amax")
        obj_bce = _bce_logits(pi[..., 4], tobj.reshape(Bi, H, W, na),
                              hyp.obj_pw)
        lobj = lobj + obj_bce.mean() * BALANCE3[i]

        if nc > 1:
            tc = torch.full((t.tcls.shape[0], nc), cn, dtype=pred.dtype,
                            device=dev)
            tc[torch.arange(t.tcls.shape[0], device=dev), t.tcls] = cp
            cls_bce = _bce_logits(pred[:, 5:5 + nc], tc, hyp.cls_pw)
            lcls = lcls + (cls_bce * m[:, None]).sum() / (n * nc)

        if seg:
            li, di = _layer_mask_loss(pred[:, 5 + nc:], t.mask, targets,
                                      proto, gt_masks, na, B, T, mask_cap)
            lseg = lseg + li
            dropped = dropped + di

    items = {"box": lbox * hyp.box, "obj": lobj * hyp.obj,
             "cls": lcls * hyp.cls}
    total = items["box"] + items["obj"] + items["cls"]
    if seg:
        items["seg"] = lseg * hyp.box / B
        items["seg_dropped"] = dropped
        total = total + items["seg"]
    return total * B, items


def _layer_mask_loss(coefs, cand_mask, targets, proto, gt_masks, na, B, T,
                     mask_cap):
    """single_mask_loss over one layer's dense candidates: per image the
    first `mask_cap` valid candidates in the (5, na, T) order, the
    prototype product, BCE cropped to the target box, pixel mean over box
    area, averaged over the image's kept candidates, summed over
    images."""
    Hm, Wm = proto.shape[1], proto.shape[2]
    C = 5 * na * T
    dev = proto.device

    def per_img(x):                       # (5*na*B*T, ...) -> (B, C, ...)
        x = x.reshape((5, na, B, T) + tuple(x.shape[1:]))
        return x.movedim(2, 0).reshape((B, C) + tuple(x.shape[4:]))

    vm = per_img(cand_mask)                                    # (B, C)
    order = torch.argsort((~vm).to(torch.uint8), dim=1,
                          stable=True)[:, :mask_cap]           # (B, Km)
    vsel = torch.gather(vm, 1, order)
    csel = torch.gather(per_img(coefs), 1,
                        order[..., None].expand(-1, -1, coefs.shape[-1]))
    ti = order % T
    barng = torch.arange(B, device=dev)[:, None]
    xywhn = targets[barng, ti, 1:5].float()                    # (B, Km, 4)
    gt = gt_masks[barng, ti]                                   # (B, Km, Hm, Wm)
    pm = torch.einsum("bkm,bhwm->bkhw", csel, proto)
    bce = _bce_logits(pm, gt.to(pm.dtype), 1.0)
    scale = torch.tensor([Wm, Hm, Wm, Hm], dtype=torch.float32, device=dev)
    mx = xywhn * scale
    x1, y1 = mx[..., 0] - mx[..., 2] / 2, mx[..., 1] - mx[..., 3] / 2
    x2, y2 = mx[..., 0] + mx[..., 2] / 2, mx[..., 1] + mx[..., 3] / 2
    r = torch.arange(Wm, dtype=torch.float32, device=dev)[None, None, None]
    c = torch.arange(Hm, dtype=torch.float32, device=dev)[None, None, :, None]
    inbox = ((r >= x1[..., None, None]) & (r < x2[..., None, None])
             & (c >= y1[..., None, None]) & (c < y2[..., None, None]))
    area = (xywhn[..., 2] * xywhn[..., 3]).clamp(min=1e-9)
    per_cand = (bce * inbox).mean((2, 3)) / area               # (B, Km)
    vself = vsel.to(per_cand.dtype)
    n_b = vself.sum(1)
    per_image = (per_cand * vself).sum(1) / n_b.clamp(min=1.0)
    dropped = (vm.sum(1) - mask_cap).clamp(min=0).sum()
    return per_image.sum(), dropped
