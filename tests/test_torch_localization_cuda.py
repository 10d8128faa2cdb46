"""BMN and the SSN head on the card, each against the same computation on
the CPU: a forward and one training step from the same state, at a small
size (BMN T=20, N=4, D=20, hidden 16/8/16, batch 2; SSN T=24, 3
classes, hidden 16, two videos of four proposals).  No hand-written
kernel runs in these models.

Skips without CUDA.  The repository's conftest imports jax, which the
machine with the card does not have, so run this file there with:

    python -m pytest --noconftest -q tests/test_torch_localization_cuda.py

(chip_smoke.py step 22 makes the same checks at the shipped configs'
width.)  This file imports neither jax nor the JAX package.

Tolerances, f32 with TF32 off: outputs within 1e-5 of each output's
largest magnitude; the step's loss within 1e-5 relative and each
gradient within 1e-4 of its largest magnitude; the parameters after the
step within 1e-5 of their largest (the SGD step; BMN's AdamW step holds
the elements whose gradient is below 1e-6 to 2 lr).
"""

import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu_torch.models import bmn, ssn
from cross_modal_video_engine_tpu_torch.models.recognizer import (
    conv_init_state_dict)
from cross_modal_video_engine_tpu_torch.train import localization_trainer as lt
from cross_modal_video_engine_tpu_torch.utils.precision import no_tf32

pytestmark = pytest.mark.cuda

BMN_CFG = bmn.BMNConfig(temporal_dim=20, feat_dim=8, num_samples=4,
                        max_duration=20, hidden_1d=16, hidden_2d=8,
                        hidden_3d=16)
SSN_CFG = ssn.SSNConfig(feat_dim=8, num_classes=3, hidden=16)
SAMPLER = lt.SSNSamplerConfig(positive_per_video=1, incomplete_per_video=2,
                              background_per_video=1)
LR = 1e-3


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


def _model(kind, d):
    m = (bmn.BMN(BMN_CFG, device=d) if kind == "bmn"
         else ssn.SSNHead(SSN_CFG, device=d))
    m.load_state_dict(conv_init_state_dict(m, 3))
    return m


def _batch(kind):
    rng = np.random.default_rng(5)
    if kind == "bmn":
        labels = [lt.bmn_labels(np.sort(rng.uniform(0, 1, (2, 2)), -1),
                                20, 20) for _ in range(2)]
        gt = [np.stack([l[i] for l in labels]) for i in range(3)]
        mask = np.broadcast_to(lt.bm_mask(20, 20), (2, 20, 20)).copy()
        draws = tuple(rng.random((2, 20, 20), np.float32) for _ in range(2))
        x = rng.standard_normal((2, 20, 8)).astype(np.float32)
        return (x, *gt, mask), {"draws": draws}
    props = np.sort(rng.uniform(0, 24, (2, 4, 2)), -1)
    stpp = np.stack([ssn.stpp_matrix(24, p) for p in props])
    feats = rng.standard_normal((2, 24, 8)).astype(np.float32)
    labels = np.array([[2, 1, 3, 0], [3, 3, 2, 0]])
    ptype = np.array([[0, 1, 1, 2]] * 2)
    targets = rng.standard_normal((2, 4, 2)).astype(np.float32)
    return (feats, stpp, labels, ptype, targets), {}


def _run(kind, d):
    torch.manual_seed(0)
    m = _model(kind, d)
    args, kw = _batch(kind)
    targs = [torch.from_numpy(a).to(d) for a in args]
    with torch.no_grad():
        out = m(*targs[:1 if kind == "bmn" else 2])
    if kind == "bmn":
        tx, step = (lt.make_loc_optimizer("adamw", LR),
                    lt.make_bmn_train_step(m, device=d))
    else:
        tx, step = (lt.make_loc_optimizer("sgd", LR, 1e-4),
                    lt.make_ssn_batch_train_step(m, SAMPLER, device=d))
    state, logs = step(lt.init_loc_state(m, tx), *targs, **kw)
    return out, float(logs["loss"]), {
        n: (p.grad.cpu(), p.detach().cpu()) for n, p in m.named_parameters()}


@pytest.mark.parametrize("kind", ["bmn", "ssn"])
def test_forward_and_step_card_vs_cpu(kind, dev):
    out_c, loss_c, params_c = _run(kind, dev)
    out_h, loss_h, params_h = _run(kind, torch.device("cpu"))
    for k in out_h:
        assert _rel(out_c[k], out_h[k]) <= 1e-5, k
    assert abs(loss_c - loss_h) <= 1e-5 * abs(loss_h)
    for n, (g, p) in params_h.items():
        gc, pc = params_c[n]
        assert _rel(gc, g) <= 1e-4, n
        if kind == "bmn":
            m = g.abs() < 1e-6
            if m.any():
                assert float((pc[m] - p[m]).abs().max()) <= 2 * LR, n
            pc, p = pc[~m], p[~m]
        if p.numel():
            assert _rel(pc, p) <= 1e-5, n
