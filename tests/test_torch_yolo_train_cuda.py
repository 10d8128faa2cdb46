"""The detector trainers' steps and the caption transformer on the card,
each against the same computation on the CPU (the plain arm: no kernel
runs in YOLO, and the caption transformer's flash launches are counted),
at a small size (width 0.125, 128 px; vocab 40, width 32).

Skips without CUDA.  The repository's conftest imports jax, which the
machine with the card does not have, so run this file there with:

    python -m pytest --noconftest -q tests/test_torch_yolo_train_cuda.py

(chip_smoke.py step 17 makes the same checks at full width.)  This file
imports neither jax nor the JAX package.

Tolerances, f32 with TF32 off: the loss within 1e-5 relative; each
gradient at cosine 0.9999 (SPPF's max pools may route a near-tied
window's gradient to another element on each side); BatchNorm statistics
within 1e-4 of their largest.  bf16: a finite loss within 5e-2 of the
f32 step's and f32 masters.  The caption transformer: teacher-forcing
logits within 1e-4, greedy ids equal, one flash launch per layer and
call.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu_torch.losses.yolo import YoloHyp
from cross_modal_video_engine_tpu_torch.models import yolo as tyolo
from cross_modal_video_engine_tpu_torch.train import yolo_trainer as yt
from cross_modal_video_engine_tpu_torch.utils.precision import no_tf32

pytestmark = pytest.mark.cuda

DETECT = tyolo.YoloConfig(num_classes=3, depth_multiple=0.33,
                          width_multiple=0.125, img_size=128)
KINDS = {"detect": DETECT, "segment": dataclasses.replace(DETECT, masks=4,
                                                          protos=16),
         "classify": DETECT}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    no_tf32()
    yield torch.device("cuda", 0)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


def _batch(kind, seed=3, b=2, t=4):
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.random((b, 128, 128, 3), np.float32))
    if kind == "classify":
        return images, torch.from_numpy(rng.integers(0, 3, b))
    targets = np.concatenate([rng.integers(0, 3, (b, t, 1)),
                              rng.uniform(0.2, 0.8, (b, t, 2)),
                              rng.uniform(0.1, 0.5, (b, t, 2))], -1)
    out = [images, torch.from_numpy(targets.astype(np.float32)),
           torch.ones((b, t), dtype=torch.bool)]
    if kind == "segment":
        out.append(torch.from_numpy(
            (rng.random((b, t, 32, 32)) > 0.5).astype(np.float32)))
    return out


def _step(kind, where, bf16=False):
    cfg = KINDS[kind]
    cls = tyolo.YoloClassifier if kind == "classify" else tyolo.YoloV5
    model = cls(cfg, device=where)
    state = yt.init_yolo_train_state(model, seed=0)
    opt = yt.YoloOptHyp()
    sched = yt.lr_momentum_at(50, 5, 10, 3, opt)
    batch = [t.to(where) for t in _batch(kind)]
    if kind == "classify":
        step = yt.make_yolo_cls_train_step(model, opt, 5e-5, bf16=bf16,
                                           device=where)
        state, logs = step(state, *batch, *sched)
    else:
        step = yt.make_yolo_train_step(model, YoloHyp(), opt, 5e-4,
                                       bf16=bf16, device=where)
        extra = {"gt_masks": batch[3]} if kind == "segment" else {}
        state, logs = step(state, *batch[:3], *sched, **extra)
    grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
    return float(logs["loss"]), grads, yt.state_tensors(state)


def _cos(a, b):
    a, b = a.double().ravel(), b.double().ravel()
    if not a.any() and not b.any():
        return 1.0
    return float(torch.nn.functional.cosine_similarity(a, b, 0))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_f32_step_card_vs_cpu(dev, kind):
    lc, gc, sc = _step(kind, dev)
    lp, gp, sp = _step(kind, torch.device("cpu"))
    assert abs(lc - lp) <= 1e-5 * abs(lp)
    for k in gp:
        assert _cos(gc[k], gp[k]) >= 0.9999, k
    for k, v in sc["batch_stats"].items():
        want = sp["batch_stats"][k]
        assert float((v.cpu() - want).abs().max()) <= 1e-4 * float(
            want.abs().max()), k


@pytest.mark.parametrize("kind", ["detect", "classify"])
def test_bf16_step_keeps_f32_masters(dev, kind):
    lb, _, sb = _step(kind, dev, bf16=True)
    lf, _, _ = _step(kind, dev)
    assert np.isfinite(lb) and abs(lb - lf) <= 5e-2 * abs(lf)
    for part in sb.values():
        for k, v in part.items():
            assert v.dtype == torch.float32, k


def test_caption_transformer_card_vs_cpu(dev):
    from cross_modal_video_engine_tpu_torch.models import (
        caption_transformer as ct)
    from cross_modal_video_engine_tpu_torch.models.recognizer import (
        Recognizer3DCaption, random_state_dict)
    from cross_modal_video_engine_tpu_torch.models.timesformer import (
        TimeSformerConfig)
    from cross_modal_video_engine_tpu_torch.ops import flash_attention as fa
    bcfg = TimeSformerConfig(num_frames=4, img_size=32, patch_size=16,
                             embed_dims=64, num_heads=2, num_layers=2,
                             attention_type="joint_space_time",
                             use_flash_attention=True)
    ccfg = ct.CaptionConfig(vocab_size=40, d_model=32, heads=4, layers=2,
                            max_len=6, enc_dim=64)
    sd = {k: v for k, v in random_state_dict(bcfg, 1, num_classes=1).items()
          if k.startswith("backbone.")}
    sd.update({f"caption_head.{k}": v
               for k, v in ct.random_state_dict(ccfg, 2).items()})
    rng = np.random.default_rng(4)
    videos = torch.from_numpy(rng.standard_normal(
        (2, 4, 32, 32, 3)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(3, 40, (2, 6)))
    out = {}
    for where in (dev, torch.device("cpu")):
        model = Recognizer3DCaption(bcfg, ccfg, device=where)
        model.load_state_dict(sd)
        fa.flash_attention.launches = 0
        with torch.no_grad():
            logits = model(videos.to(where), ids.to(where)).cpu()
            greedy = model.generate(videos.to(where), "greedy")[0].cpu()
        if where.type == "cuda":
            torch.cuda.synchronize()
            assert fa.flash_attention.launches == 2 * bcfg.num_layers
        out[where.type] = logits, greedy
    (lc, gc), (lp, gp) = out["cuda"], out["cpu"]
    assert float((lc - lp).abs().max()) <= 1e-4 * float(lp.abs().max())
    assert torch.equal(gc, gp)
