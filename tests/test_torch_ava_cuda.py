"""The AVA detectors on the card, each against the same computation on the
CPU: the forward and one training step from the same seeded weights, at a
small size (SlowOnly stage_blocks (1, 1, 1, 1), base_channels 8, 4 frames
of 32², batch 2 with 6 RoIs, 4 classes; ACRN out 8; FBO latent 8 with one
non-local layer over a 6-row window).  No hand-written kernel runs in
these models.

Skips without CUDA.  The repository's conftest imports jax, which the
machine with the card does not have, so run this file there with:

    python -m pytest --noconftest -q tests/test_torch_ava_cuda.py

(chip_smoke.py step 23 makes the same checks at the shipped configs'
width.)  This file imports neither jax nor the JAX package.

Tolerances, f32 with TF32 off: logits within 1e-5 of their largest
magnitude; the step (SGD with momentum, the clip engaged, the same
handed-in dropout masks) within 1e-5 relative in the loss and STEP_TOL
(1e-3) of each tensor's largest after the step: train-mode BatchNorm over
two clips of small maps makes the backbone's f32 gradients
ill-conditioned on either device (the stem's weight moves 5e-5 to 2e-4
of its largest apart between the card and the CPU), so the gradients
themselves are held in float64, each within 1e-9 of its tensor's largest
(a gradient that is zero but for rounding, the non-local key bias's,
within 1e-9 of 1e-6 of the model's largest).  The weights are seeded
draws, not the training init.
"""

import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu_torch.cli import detection_train as dtc
from cross_modal_video_engine_tpu_torch.config import Config
from cross_modal_video_engine_tpu_torch.train import detection_trainer as dt
from cross_modal_video_engine_tpu_torch.train import recognition_trainer as rt
from cross_modal_video_engine_tpu_torch.utils.precision import no_tf32

pytestmark = pytest.mark.cuda

BACKBONE = dict(type="SlowOnly", stage_blocks=[1, 1, 1, 1], base_channels=8,
                conv1_kernel_t=1, stage_temporal_kernels=[1, 1, 3, 3],
                stage_spatial_strides=[1, 2, 2, 1])
SHARED = {"plain": None, "acrn": dict(type="ACRN", out_channels=8),
          "fbo": dict(type="FBO", latent_channels=8, num_non_local_layers=1)}
ROIS = np.array([[0, .1, .1, .5, .6], [1, -.2, .3, .4, 1.3],
                 [1, 1.1, 1.2, 1.5, 1.4], [0, 0, 0, 1, 1],
                 [1, .3, .3, .3, .3], [0, .6, .2, .9, .9]], np.float32)
TOL, STEP_TOL, F64_TOL, F64_FLOOR = 1e-5, 1e-3, 1e-9, 1e-6


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


def _rel(a, b) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / scale if scale else float(
        (a - b).abs().max())


def seeded_state(model, seed: int) -> dict:
    """Every float tensor of the model's state redrawn from a numpy seed:
    kernels at lecun-normal scale, biases small, BatchNorm and LayerNorm
    scales near 1, running variances near 1."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in model.state_dict().items():
        if not v.is_floating_point():
            out[k] = v.clone()
            continue
        shape = tuple(v.shape)
        if k.endswith("running_var"):
            a = 0.5 + np.abs(rng.standard_normal(shape))
        elif k.endswith("bias") or k.endswith("running_mean"):
            a = 0.02 * rng.standard_normal(shape)
        elif v.dim() == 1:
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        out[k] = torch.from_numpy(np.asarray(a, np.float32))
    return out


def _model(kind, d, state, dropout=0.5):
    model = {"backbone": BACKBONE, "roi_head": dict(
        num_classes=4, roi_size=2, sampling_ratio=1, dropout=dropout)}
    if SHARED[kind]:
        model["shared_head"] = SHARED[kind]
    m = dtc.build_detection_model(Config({"model": model}), d)
    if state is not None:
        m.load_state_dict(state)
    return m


def _inputs(kind):
    rng = np.random.default_rng(3)
    clips = rng.standard_normal((2, 4, 32, 32, 3)).astype(np.float32)
    lt = (rng.standard_normal((len(ROIS), 6, 256)).astype(np.float32)
          if kind == "fbo" else None)
    return clips, lt


@pytest.mark.parametrize("kind", ["plain", "acrn", "fbo"])
def test_detector_forward_card_matches_cpu(dev, kind):
    state = seeded_state(_model(kind, "cpu", None), 1)
    clips, lt = _inputs(kind)
    out = []
    for d in (dev, torch.device("cpu")):
        m = _model(kind, d, state).eval()
        with torch.no_grad():
            out.append(m(torch.from_numpy(clips).to(d),
                         torch.from_numpy(ROIS).to(d),
                         lt_feat=None if lt is None else
                         torch.from_numpy(lt).to(d)))
    assert out[0].shape == (len(ROIS), 4)
    assert torch.isfinite(out[0]).all()
    assert _rel(out[0], out[1]) <= TOL


@pytest.mark.parametrize("kind", ["plain", "acrn", "fbo"])
def test_detector_step_card_matches_cpu(dev, kind):
    state = seeded_state(_model(kind, "cpu", None), 2)
    clips, lt = _inputs(kind)
    rng = np.random.default_rng(4)
    n = len(ROIS)
    labels = (rng.random((n, 4)) > 0.6).astype(np.float32)
    valid = np.array([1, 1, 1, 1, 0, 1], np.float32)
    head = (n, 264) if kind == "fbo" else (n, 8 if kind == "acrn" else 256)
    shapes = ([(n, 1, 8), (n, 6, 8), (n, 1, 8)] if kind == "fbo" else []) \
        + [head]
    masks = [torch.from_numpy(rng.random(s) >= 0.3) for s in shapes]
    tcfg = rt.RecognitionTrainConfig(optimizer="sgd", learning_rate=0.05,
                                     grad_clip=0.5)
    runs = []
    for d in (dev, torch.device("cpu")):
        m = _model(kind, d, state)
        st = rt.init_rec_state(m, rt.make_rec_optimizer(tcfg))
        step = dt.make_det_train_step(m, device=d)
        _, logs = step(st, clips, ROIS, labels, valid, lt,
                       draws=[x.to(d) for x in masks])
        runs.append((float(logs["loss"]), m.state_dict()))
    (lc, sc), (lp, sp) = runs
    assert np.isfinite(lc) and abs(lc - lp) <= TOL * abs(lp)
    for k, v in sp.items():
        if v.is_floating_point():
            assert _rel(sc[k], v) <= STEP_TOL, k


@pytest.mark.parametrize("kind", ["plain", "acrn", "fbo"])
def test_detector_float64_gradients_card_match_cpu(dev, kind):
    """The train-mode loss's gradients and running statistics in float64,
    the same masks on both devices."""
    from cross_modal_video_engine_tpu_torch.models.ava_head import (
        ava_bbox_loss)
    state = seeded_state(_model(kind, "cpu", None), 2)
    clips, lt = _inputs(kind)
    rng = np.random.default_rng(4)
    n = len(ROIS)
    labels = torch.from_numpy((rng.random((n, 4)) > 0.6).astype(np.float64))
    valid = torch.tensor([1, 1, 1, 1, 0, 1], dtype=torch.float64)
    head = (n, 264) if kind == "fbo" else (n, 8 if kind == "acrn" else 256)
    shapes = ([(n, 1, 8), (n, 6, 8), (n, 1, 8)] if kind == "fbo" else []) \
        + [head]
    masks = [torch.from_numpy(rng.random(s) >= 0.3) for s in shapes]
    runs = []
    for d in (dev, torch.device("cpu")):
        m = _model(kind, d, state).double().train()
        with dt.handed_masks(m, [x.to(d) for x in masks]):
            logits = m(torch.from_numpy(clips).to(d, torch.float64),
                       torch.from_numpy(ROIS).to(d), lt_feat=None
                       if lt is None else torch.from_numpy(lt).to(
                           d, torch.float64))
        ava_bbox_loss(logits, labels.to(d), valid.to(d)).backward()
        runs.append(({k: p.grad for k, p in m.named_parameters()},
                     {k: v for k, v in m.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))}))
    (gc, sc), (gp, sp) = runs
    floor = F64_FLOOR * max(float(g.abs().max()) for g in gp.values())
    for k, g in gp.items():
        err = float((gc[k].cpu() - g).abs().max())
        assert err <= F64_TOL * max(float(g.abs().max()), floor), k
    for k, v in sp.items():
        assert _rel(sc[k], v) <= F64_TOL, k
