"""YOLOv5 object detector (the concept-mask generator) in PyTorch, inference.

Counterpart of cross_modal_video_engine_tpu/models/yolo.py, the rebuild
of the MCT yolov5 fork's model (MCT/yolov5/models/yolo.py +
models/common.py): CSP backbone (Conv/C3/SPPF), PANet neck, the 3-scale
anchor-based Detect head (or the Segment head with its prototypes), the
yolov5-cls classifier, the decode, test-time augmentation and the host
NMS.

Parameter names are the ultralytics sequential layout (`model.0.conv.weight`
... `model.24.m.{i}.weight`, the buffer `model.24.anchors` in grid units,
`model.24.proto.cv*` for the segment head; the classifier ends in
`model.9.{conv,linear}`), which the JAX package's
`convert_yolov5`/`convert_yolov5_cls` read, so one state dict loads into
both packages.  The modules compute in NCHW (cuDNN's layout) and take
(B, H, W, 3) images in [0, 1]; the raw maps come back (B, Hi, Wi,
3·(5+nc+nm)) as the JAX model returns them.

Train mode (`model.train()`) follows flax's BatchNorm (JAX models/yolo.py
:57-62): the batch statistics normalize, and the running statistics move
by running = 0.97 * running + 0.03 * batch with the *biased* batch
variance (`BatchNorm` is layers.FlaxBatchNorm at eps 1e-3 and momentum
0.03).  The raw maps come out in the same layout in both modes,
which losses/yolo.py indexes.  In eval mode BatchNorm normalizes by its
running statistics with eps 1e-3.  The Detect biases come from the
weights (`init_state_dict` draws the training init with yolov5's priors).
On the card cuDNN runs f32 convolutions in TF32 unless it is turned off:
the f32 entry points call utils/precision.no_tf32().

Frame sizes: the PANet concatenations need the stride-16 and stride-32
maps to differ by exactly 2x, so a size that is not a multiple of 32
(360x480, 340x256) fails in the JAX model's concatenation; the port
raises a ValueError there (`SIZE_FAULT`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.preprocess import resize_weights
from ..utils.device import resolve_device
from .layers import FlaxBatchNorm

# yolov5 P5 anchors (pixels at strides 8/16/32)
DEFAULT_ANCHORS = (
    ((10, 13), (16, 30), (33, 23)),
    ((30, 61), (62, 45), (59, 119)),
    ((116, 90), (156, 198), (373, 326)),
)
STRIDES = (8, 16, 32)

SIZE_FAULT = ("the detector needs frames whose height and width are multiples "
              "of 32: the JAX package's YoloV5 fails in its PANet "
              "concatenation on other sizes, and its ctv_build hands decoded "
              "frames to it without a letterbox (ROADMAP.md queue 3, "
              "'ctv_build without a letterbox')")


@dataclasses.dataclass(frozen=True)
class YoloConfig:
    num_classes: int = 80
    depth_multiple: float = 0.33     # yolov5n/s
    width_multiple: float = 0.25     # yolov5n
    img_size: int = 640
    anchors: Tuple = DEFAULT_ANCHORS
    masks: int = 0                   # nm > 0 = Segment head (yolov5-seg)
    protos: int = 0                  # npr channels; 0 = width-scaled 256
    # the JAX package's space-to-depth stem, a TPU retiling the port does
    # not carry (ROADMAP.md "Do not port"): True raises
    s2d_stem: bool = False

    def __post_init__(self):
        if self.s2d_stem:
            raise ValueError("s2d_stem is a TPU retiling of the stem the port "
                             "does not carry; the stem is one convolution")

    def depth(self, n: int) -> int:
        return max(1, round(n * self.depth_multiple))

    def width(self, c: int) -> int:
        return int(np.ceil(c * self.width_multiple / 8) * 8)


class BatchNorm(FlaxBatchNorm):
    """layers.FlaxBatchNorm at ultralytics' eps 1e-3 and momentum 0.03:
    flax's train-mode update of the running variance by the biased batch
    variance (JAX models/yolo.py), torch's normalization; no batch count
    (the detector trainers resume from JAX-format states)."""

    count_batches = False

    def __init__(self, c: int, device=None):
        super().__init__(c, eps=1e-3, momentum=0.03, device=device)


class Conv(nn.Module):
    """ultralytics Conv: conv (no bias) + BatchNorm(eps 1e-3) + SiLU."""

    def __init__(self, cin: int, cout: int, k: int = 1, s: int = 1,
                 p: int = -1, device=None):
        super().__init__()
        p = k // 2 if p < 0 else p
        self.conv = nn.Conv2d(cin, cout, k, s, p, bias=False, device=device)
        self.bn = BatchNorm(cout, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, cin: int, cout: int, shortcut: bool = True,
                 device=None):
        super().__init__()
        self.cv1 = Conv(cin, cout, 1, device=device)
        self.cv2 = Conv(cout, cout, 3, device=device)
        self.add = shortcut and cin == cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    def __init__(self, cin: int, cout: int, n: int = 1,
                 shortcut: bool = True, device=None):
        super().__init__()
        c_ = cout // 2
        self.cv1 = Conv(cin, c_, 1, device=device)
        self.cv2 = Conv(cin, c_, 1, device=device)
        self.cv3 = Conv(2 * c_, cout, 1, device=device)
        self.m = nn.Sequential(*[Bottleneck(c_, c_, shortcut, device=device)
                                 for _ in range(n)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(torch.cat((self.m(self.cv1(x)), self.cv2(x)), 1))


class SPPF(nn.Module):
    """Three chained 5x5 max-pools (stride 1, padded with -inf)."""

    def __init__(self, cin: int, cout: int, k: int = 5, device=None):
        super().__init__()
        c_ = cin // 2
        self.cv1 = Conv(cin, c_, 1, device=device)
        self.cv2 = Conv(c_ * 4, cout, 1, device=device)
        self.k = k

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cv1(x)
        pool = lambda y: F.max_pool2d(y, self.k, 1, self.k // 2)
        y1 = pool(x)
        y2 = pool(y1)
        return self.cv2(torch.cat((x, y1, y2, pool(y2)), 1))


class Proto(nn.Module):
    """Mask prototypes (common.py Proto): 3x3 conv, 2x nearest upsample,
    3x3 conv, 1x1 conv to nm channels (stride 8 -> stride 4)."""

    def __init__(self, cin: int, npr: int, nm: int, device=None):
        super().__init__()
        self.cv1 = Conv(cin, npr, 3, device=device)
        self.cv2 = Conv(npr, npr, 3, device=device)
        self.cv3 = Conv(npr, nm, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.interpolate(self.cv1(x), scale_factor=2, mode="nearest")
        return self.cv3(self.cv2(x))


class Detect(nn.Module):
    """The head's three 1x1 convs, the anchors buffer in grid units and,
    for the segment head, the prototypes."""

    def __init__(self, cfg: YoloConfig, chs: Sequence[int], device=None):
        super().__init__()
        no = 3 * (5 + cfg.num_classes + cfg.masks)
        self.m = nn.ModuleList([nn.Conv2d(c, no, 1, device=device)
                                for c in chs])
        self.register_buffer("anchors", torch.empty(3, 3, 2, device=device))
        if cfg.masks > 0:
            self.proto = Proto(chs[0], cfg.protos or cfg.width(256),
                               cfg.masks, device=device)


def _anchors_in_grid_units(cfg: YoloConfig) -> torch.Tensor:
    a = torch.tensor(cfg.anchors, dtype=torch.float32)
    return a / torch.tensor(STRIDES, dtype=torch.float32).view(3, 1, 1)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _cat_checked(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.shape[2:] != b.shape[2:]:
        raise ValueError(f"{SIZE_FAULT}: maps {tuple(a.shape[2:])} and "
                         f"{tuple(b.shape[2:])} do not concatenate")
    return torch.cat((a, b), 1)


class _Inference(nn.Module):
    """Built on the meta device, then materialised on `device` with zero
    convolutions and unit BatchNorms: a model is meant to be loaded from
    a state dict, and building draws nothing from torch's generator."""

    def _materialise(self, cfg: YoloConfig, device) -> None:
        self.to_empty(device=resolve_device(device))
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, BatchNorm):
                    mod.reset_parameters()
                elif isinstance(mod, (nn.Conv2d, nn.Linear)):
                    mod.weight.zero_()
                    if mod.bias is not None:
                        mod.bias.zero_()
                elif isinstance(mod, Detect):
                    mod.anchors.copy_(_anchors_in_grid_units(cfg))
        self.eval()


def _backbone(cfg: YoloConfig, meta) -> List[nn.Module]:
    w, d = cfg.width, cfg.depth
    return [
        Conv(3, w(64), 6, 2, 2, device=meta),                  # 0
        Conv(w(64), w(128), 3, 2, device=meta),                # 1
        C3(w(128), w(128), d(3), device=meta),                 # 2
        Conv(w(128), w(256), 3, 2, device=meta),               # 3
        C3(w(256), w(256), d(6), device=meta),                 # 4
        Conv(w(256), w(512), 3, 2, device=meta),               # 5
        C3(w(512), w(512), d(9), device=meta),                 # 6
        Conv(w(512), w(1024), 3, 2, device=meta),              # 7
        C3(w(1024), w(1024), d(3), device=meta),               # 8
    ]


class YoloV5(_Inference):
    """forward(images (B, H, W, 3) in [0, 1]) -> [raw maps (B, Hi, Wi,
    3·(5+nc+nm))] at strides 8/16/32, plus the prototypes (B, H/4, W/4, nm)
    when cfg.masks > 0: `(maps, proto)`."""

    def __init__(self, cfg: YoloConfig, device=None):
        super().__init__()
        self.cfg = cfg
        w, d = cfg.width, cfg.depth
        meta = torch.device("meta")
        self.model = nn.ModuleList(_backbone(cfg, meta) + [
            SPPF(w(1024), w(1024), device=meta),               # 9
            Conv(w(1024), w(512), 1, device=meta),             # 10
            nn.Upsample(scale_factor=2, mode="nearest"),       # 11
            nn.Identity(),                                     # 12 concat
            C3(w(1024), w(512), d(3), False, device=meta),     # 13
            Conv(w(512), w(256), 1, device=meta),              # 14
            nn.Upsample(scale_factor=2, mode="nearest"),       # 15
            nn.Identity(),                                     # 16 concat
            C3(w(512), w(256), d(3), False, device=meta),      # 17
            Conv(w(256), w(256), 3, 2, device=meta),           # 18
            nn.Identity(),                                     # 19 concat
            C3(w(512), w(512), d(3), False, device=meta),      # 20
            Conv(w(512), w(512), 3, 2, device=meta),           # 21
            nn.Identity(),                                     # 22 concat
            C3(w(1024), w(1024), d(3), False, device=meta),    # 23
            Detect(cfg, (w(256), w(512), w(1024)), device=meta),  # 24
        ])
        self._materialise(cfg, device)

    def forward(self, images: torch.Tensor):
        m = self.model
        x = images.permute(0, 3, 1, 2)
        x = m[1](m[0](x))
        p3 = m[4](m[3](m[2](x)))
        p4 = m[6](m[5](p3))
        p5 = m[9](m[8](m[7](p4)))
        u5 = m[10](p5)
        n4 = m[13](_cat_checked(m[11](u5), p4))
        u4 = m[14](n4)
        n3 = m[17](_cat_checked(m[15](u4), p3))
        n4b = m[20](_cat_checked(m[18](n3), u4))
        n5b = m[23](_cat_checked(m[21](n4b), u5))
        det = m[24]
        outs = [_nhwc(det.m[i](f)) for i, f in enumerate((n3, n4b, n5b))]
        if self.cfg.masks > 0:
            return outs, _nhwc(det.proto(n3))
        return outs


class Classify(nn.Module):
    """yolov5-cls head (common.py Classify): 1x1 conv to 1280 channels,
    global average pool, linear to nc (dropout p=0)."""

    def __init__(self, cin: int, nc: int, device=None):
        super().__init__()
        self.conv = Conv(cin, 1280, 1, device=device)
        self.linear = nn.Linear(1280, nc, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(self.conv(x).mean(dim=(2, 3)))


class YoloClassifier(_Inference):
    """yolov5-cls: the detection backbone up to model.8, then Classify at
    model.9.  forward(images (B, H, W, 3)) -> logits (B, nc)."""

    def __init__(self, cfg: YoloConfig, device=None):
        super().__init__()
        self.cfg = cfg
        meta = torch.device("meta")
        self.model = nn.ModuleList(_backbone(cfg, meta) + [
            Classify(cfg.width(1024), cfg.num_classes, device=meta)])
        self._materialise(cfg, device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2)
        for mod in self.model:
            x = mod(x)
        return x


def random_state_dict(cfg: YoloConfig, seed: int = 0,
                      classifier: bool = False,
                      fire: Sequence[int] = ()) -> Dict[str, torch.Tensor]:
    """An ultralytics-layout state dict of random f32 weights from a numpy
    seed: convolutions at fan-in scale, BatchNorm scales near 1, running
    means small and running variances in (0.6, 1.4); the Detect biases
    at yolov5's priors (_initialize_biases:
    objectness log(8 / (640/stride)^2), classes log(0.6 / (nc - 0.99))),
    so few anchors clear a threshold.  `fire`: up to 3 classes; at stride
    32, on anchor j the j-th has its logit raised by 12 and every other
    class's lowered by 12, anchor j's objectness is raised by 6 (scores
    near 0.9, not saturated, so NMS meets few ties) and its width and
    height logits by 2 (boxes of about 3x the anchor: 116x90, 156x198,
    373x326 pixels), and the other anchors' objectness is lowered by 6:
    each fires on every image, alone in its boxes, NMS keeps a few tens
    of them, and few other boxes clear even the val protocol's 0.001.
    Both packages load it (the JAX one through convert_yolov5 /
    convert_yolov5_cls)."""
    rng = np.random.default_rng(seed)
    net = (YoloClassifier if classifier else YoloV5)(cfg, device="meta")
    no = 5 + cfg.num_classes + cfg.masks
    out = {}
    for name, t in net.state_dict().items():
        shape = tuple(t.shape)
        last = name.rsplit(".", 1)[-1]
        if last == "num_batches_tracked":
            out[name] = torch.zeros((), dtype=torch.int64)
            continue
        if last == "anchors":
            out[name] = _anchors_in_grid_units(cfg)
            continue
        z = rng.standard_normal(shape, dtype=np.float32)
        head = name.startswith("model.24.m.")
        if ".bn." in name and last == "running_mean":
            a = 0.1 * z
        elif ".bn." in name and last == "running_var":
            a = 1.0 + 0.4 * np.tanh(z)
        elif ".bn." in name and last == "weight":
            a = 1.0 + 0.1 * z
        elif head and last == "bias":
            stride = STRIDES[int(name.split(".")[3])]
            b = detect_bias_prior(cfg, stride).reshape(3, no)
            if fire and stride == 32:
                b[len(fire):, 4] -= 6.0
                for j, c in enumerate(fire):
                    b[j, 5:5 + cfg.num_classes] -= 12.0
                    b[j, 5 + c] += 24.0
                    b[j, 4] += 6.0
                    b[j, 2:4] += 2.0
            a = b.reshape(-1) + 0.1 * z
        elif last == "bias":
            a = 0.02 * z
        else:
            a = int(np.prod(shape[1:])) ** -0.5 * z
        out[name] = torch.from_numpy(np.asarray(a, np.float32))
    return out


def detect_bias_prior(cfg: YoloConfig, stride: int) -> np.ndarray:
    """The Detect biases' priors (_initialize_biases, JAX
    _detect_bias_init): objectness log(8 / (640/stride)^2), classes
    log(0.6 / (nc - 0.999999)), (3 * no,) f32."""
    b = np.zeros((3, 5 + cfg.num_classes + cfg.masks), np.float32)
    b[:, 4] = math.log(8.0 / (640.0 / stride) ** 2)
    b[:, 5:5 + cfg.num_classes] = math.log(0.6 / (cfg.num_classes - 0.999999))
    return b.reshape(-1)


def init_state_dict(cfg: YoloConfig, seed: int = 0,
                    classifier: bool = False) -> Dict[str, torch.Tensor]:
    """The state dict training starts from, drawn from a numpy seed with
    the schemes the JAX modules init with: convolution and linear kernels
    lecun-normal (truncated normal, fan-in the input channels times the
    receptive field), BatchNorm scales one and biases zero, running means
    zero and variances one, the Detect biases at their priors, the
    classifier's linear bias zero.  The same distributions as
    `model.init`, not the same numbers."""
    from .recognizer import _lecun_normal
    rng = np.random.default_rng(seed)
    net = (YoloClassifier if classifier else YoloV5)(cfg, device="meta")
    out: Dict[str, torch.Tensor] = {}
    for name, t in net.state_dict().items():
        shape = tuple(t.shape)
        owner, last = name.rsplit(".", 1)
        if last == "num_batches_tracked":
            out[name] = torch.zeros((), dtype=torch.int64)
        elif last == "anchors":
            out[name] = _anchors_in_grid_units(cfg)
        elif last in ("running_mean", "bias") and not owner.startswith(
                "model.24.m."):
            out[name] = torch.zeros(shape)
        elif last == "running_var" or (last == "weight" and
                                       owner.endswith(".bn")):
            out[name] = torch.ones(shape)
        elif last == "bias":
            out[name] = torch.from_numpy(detect_bias_prior(
                cfg, STRIDES[int(owner.rsplit(".", 1)[1])]))
        else:
            out[name] = _lecun_normal(rng, shape, int(np.prod(shape[1:])))
    return {k: v.float() if v.is_floating_point() else v
            for k, v in out.items()}


def decode_predictions(raw_maps: Sequence[torch.Tensor], cfg: YoloConfig
                       ) -> torch.Tensor:
    """yolov5 head decode -> (B, N, 5+nc[+nm]) with xywh in input pixels,
    each scale flattened as (H, W, anchor) as the JAX package does.  With
    cfg.masks > 0 the mask coefficients pass through raw."""
    outs = []
    nc, nm = cfg.num_classes, cfg.masks
    for raw, stride, anchors in zip(raw_maps, STRIDES, cfg.anchors):
        B, H, W, _ = raw.shape
        x = raw.reshape(B, H, W, 3, 5 + nc + nm)
        sig = torch.sigmoid(x[..., :5 + nc])
        gy, gx = torch.meshgrid(
            torch.arange(H, dtype=torch.float32, device=raw.device),
            torch.arange(W, dtype=torch.float32, device=raw.device),
            indexing="ij")
        grid = torch.stack([gx, gy], -1)                      # (H, W, 2) xy
        anch = torch.tensor(anchors, dtype=torch.float32, device=raw.device)
        xy = (sig[..., :2] * 2.0 - 0.5 + grid[:, :, None, :]) * stride
        wh = (sig[..., 2:4] * 2.0) ** 2 * anch[None, None, :, :]
        parts = [xy, wh, sig[..., 4:]]
        if nm:
            parts.append(x[..., 5 + nc:])
        outs.append(torch.cat(parts, -1).reshape(B, H * W * 3, 5 + nc + nm))
    return torch.cat(outs, 1)


def process_mask(proto: np.ndarray, coefs: np.ndarray, boxes_xyxy: np.ndarray,
                 img_hw: Tuple[int, int], upsample: bool = True,
                 threshold: Optional[float] = 0.5) -> np.ndarray:
    """Instance masks from one image's prototypes (utils/segment/general.py
    process_mask): sigmoid(coefs @ proto), cropped to the box at prototype
    resolution (the box scaled in float64, compared in float32), then
    bilinear with half-pixel centres to the image (jax.image.resize's
    weights, ops/preprocess.resize_weights) and thresholded at 0.5.
    proto: (Hm, Wm, nm); coefs: (n, nm); boxes: (n, 4).  -> (n, H, W)
    bool (threshold=None: the f32 values before the threshold)."""
    Hm, Wm, nm = proto.shape
    ih, iw = img_hw
    p = torch.as_tensor(np.asarray(proto, np.float32)).reshape(Hm * Wm, nm)
    c = torch.as_tensor(np.asarray(coefs, np.float32))
    masks = torch.sigmoid(c @ p.T).reshape(-1, Hm, Wm)
    down = np.asarray(boxes_xyxy, np.float64) \
        * np.array([Wm / iw, Hm / ih, Wm / iw, Hm / ih])
    down = torch.from_numpy(down.astype(np.float32))
    r = torch.arange(Wm, dtype=torch.float32)[None, None, :]
    col = torch.arange(Hm, dtype=torch.float32)[None, :, None]
    x1, y1, x2, y2 = (down[:, i, None, None] for i in range(4))
    masks = masks * ((r >= x1) & (r < x2) & (col >= y1) & (col < y2))
    if upsample and (Hm, Wm) != (ih, iw):
        if ih != Hm:
            wh = torch.from_numpy(resize_weights(Hm, ih, "bilinear"))
            masks = torch.einsum("nhw,hk->nkw", masks, wh)
        if iw != Wm:
            ww = torch.from_numpy(resize_weights(Wm, iw, "bilinear"))
            masks = torch.einsum("nhw,wk->nhk", masks, ww)
    if threshold is None:
        return masks.numpy()
    return (masks > threshold).numpy()


# -- test-time augmentation (reference models/yolo.py:206-251) ------------
# scales (1, .83, .67) x flips (none, lr, none), predictions de-scaled to
# the original frame, per-pass tails clipped, then concatenated.

TTA_SCALES = ((1.0, 0), (0.83, 3), (0.67, 0))   # (ratio, flip axis: 3=lr)


def scale_img(images: torch.Tensor, ratio: float, gs: int = 32,
              pad_value: float = 0.447) -> torch.Tensor:
    """(B, H, W, 3): bilinear resize by `ratio` (half-pixel centres, no
    antialias: the reference's F.interpolate(align_corners=False)), then
    bottom/right padding with 0.447 to the next multiple of gs."""
    if ratio == 1.0:
        return images
    B, H, W, C = images.shape
    nh, nw = int(H * ratio), int(W * ratio)
    out = F.interpolate(images.permute(0, 3, 1, 2), size=(nh, nw),
                        mode="bilinear", align_corners=False)
    ph = int(math.ceil(H * ratio / gs) * gs) - nh
    pw = int(math.ceil(W * ratio / gs) * gs) - nw
    out = F.pad(out, (0, pw, 0, ph), value=pad_value)
    return out.permute(0, 2, 3, 1)


def descale_pred(p: torch.Tensor, flip: int, scale: float,
                 img_hw: Tuple[int, int]) -> torch.Tensor:
    """Undo one TTA pass's geometry on decoded preds (B, N, 5+nc): xywh
    back to original pixels, a flipped x (3) or y (2) mirrored."""
    x = p[..., 0:1] / scale
    y = p[..., 1:2] / scale
    wh = p[..., 2:4] / scale
    if flip == 2:
        y = img_hw[0] - y
    elif flip == 3:
        x = img_hw[1] - x
    return torch.cat([x, y, wh, p[..., 4:]], -1)


def clip_augmented(ys: list, nl: int = 3) -> list:
    """Drop the first pass's coarsest-layer tail and the last pass's
    finest-layer head (_clip_augmented); assumes the decode order P3..P5
    with 4x grid-count ratios."""
    g = sum(4 ** k for k in range(nl))
    i = (ys[0].shape[1] // g) * 1
    ys[0] = ys[0][:, :-i]
    i = (ys[-1].shape[1] // g) * 4 ** (nl - 1)
    ys[-1] = ys[-1][:, i:]
    return ys


def nms(boxes_xywh: np.ndarray, scores: np.ndarray, classes: np.ndarray,
        iou_thres: float = 0.45, max_det: int = 300) -> np.ndarray:
    """Class-aware NMS on host; boxes in xywh. Returns kept row indices."""
    if len(boxes_xywh) == 0:
        return np.zeros((0,), np.int64)
    x1 = boxes_xywh[:, 0] - boxes_xywh[:, 2] / 2
    y1 = boxes_xywh[:, 1] - boxes_xywh[:, 3] / 2
    x2 = boxes_xywh[:, 0] + boxes_xywh[:, 2] / 2
    y2 = boxes_xywh[:, 1] + boxes_xywh[:, 3] / 2
    # offset by class so boxes of different classes never suppress
    off = classes.astype(np.float64) * 4096.0
    x1o, x2o = x1 + off, x2 + off
    areas = (x2 - x1) * (y2 - y1)
    order = np.argsort(-scores)
    keep = []
    while order.size and len(keep) < max_det:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1o[i], x1o[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2o[i], x2o[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.clip(xx2 - xx1, 0, None) * np.clip(yy2 - yy1, 0, None)
        iou = inter / np.maximum(areas[i] + areas[order[1:]] - inter, 1e-9)
        order = order[1:][iou <= iou_thres]
    return np.asarray(keep, np.int64)


def _candidates(conf: np.ndarray, conf_thres: float, multi_label: bool):
    """Rows and classes above conf_thres: one per (box, class) with
    multi_label (the val.py protocol), else the argmax class per box."""
    if multi_label:
        bi, cls = np.nonzero(conf > conf_thres)
        return bi, cls, conf[bi, cls]
    cls = conf.argmax(1)
    score = conf[np.arange(len(conf)), cls]
    bi = np.flatnonzero(score > conf_thres)
    return bi, cls[bi], score[bi]


def _xyxy(b: np.ndarray) -> np.ndarray:
    return np.stack([b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2,
                     b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2], 1)


def postprocess(preds: np.ndarray, conf_thres: float = 0.25,
                iou_thres: float = 0.45, max_det: int = 300,
                multi_label: bool = False) -> List[np.ndarray]:
    """(B, N, 5+nc) -> per image (n, 6): x1,y1,x2,y2,conf,cls (yolov5's
    non_max_suppression).  multi_label=False keeps the argmax class per
    box (detect.py); True one candidate per (box, class) (val.py)."""
    out = []
    for p in np.asarray(preds):
        bi, cls, score = _candidates(p[:, 4:5] * p[:, 5:], conf_thres,
                                     multi_label)
        p = p[bi]
        keep = nms(p[:, :4], score, cls, iou_thres, max_det)
        out.append(np.concatenate(
            [_xyxy(p[keep]), score[keep, None],
             cls[keep, None].astype(np.float64)], 1))
    return out


def postprocess_seg(preds: np.ndarray, protos: np.ndarray,
                    img_hw: Tuple[int, int], conf_thres: float = 0.25,
                    iou_thres: float = 0.45, max_det: int = 300,
                    multi_label: bool = False
                    ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Segmentation NMS + masks (segment/predict.py): preds (B, N,
    5+nc+nm), protos (B, Hm, Wm, nm) -> per image (det (n, 6), masks (n,
    H, W) bool)."""
    nm = protos.shape[-1]
    out = []
    for p, proto in zip(np.asarray(preds), np.asarray(protos)):
        box, obj, clsp, coefs = np.split(p, [4, 5, p.shape[1] - nm], axis=1)
        bi, cls, score = _candidates(obj * clsp, conf_thres, multi_label)
        box, coefs = box[bi], coefs[bi]
        keep = nms(box, score, cls, iou_thres, max_det)
        xyxy = _xyxy(box[keep])
        det = np.concatenate(
            [xyxy, score[keep, None], cls[keep, None].astype(np.float64)], 1)
        if len(keep):
            masks = process_mask(proto, coefs[keep], xyxy, img_hw)
        else:
            masks = np.zeros((0,) + tuple(img_hw), bool)
        out.append((det, masks))
    return out
