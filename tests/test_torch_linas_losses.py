"""The port's LINAS losses against the JAX package's, on the CPU.

Inputs come from a numpy seed; both packages get the same arrays.  Every
loss is compared by value and by gradient (`torch.autograd.grad` against
`jax.grad` with respect to every input): the triplet loss for each
similarity measure of the registry, direction, max_violation and cost
style; huber, mse_distill and kl_distill (a teacher with zeros and
negatives, so that kl's unselected branch is reached); similarity_distill
for each similarity_type (one 'svd' case on a well-conditioned similarity
matrix with distinct singular values); adaptive_similarity_loss.  'eig' has
a value only: its JAX gradient is zero and the port's loss needs none.
Tolerance: f32, rtol 1e-5 and atol 1e-6 for values and gradients, but a
relative L2 error of at most 1e-5 for two gradients that divide by small
numbers, whose elementwise comparison misses by 2e-6 to 4e-6 on elements
of 0.08 to 0.28: the 'svd' cases' (an SVD's backward divides by
the gaps between singular values; each package's f32 gradient of the
random case lies 4e-6 to 1e-5 from a float64 one; their values are held
elementwise) and adaptive_similarity_loss's with
respect to the embeddings (weighted by 1/|s1|; the trainer detaches them
and differentiates the mask only, which is held elementwise)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu.losses import distill as jd
from cross_modal_video_engine_tpu.losses import triplet as jt
from cross_modal_video_engine_tpu.utils.registry import SIMILARITIES
from cross_modal_video_engine_tpu_torch.losses import distill as td
from cross_modal_video_engine_tpu_torch.losses import triplet as tt
from cross_modal_video_engine_tpu_torch.ops import similarity as tsim

RTOL, ATOL = 1e-5, 1e-6
GRAD_REL_L2 = 1e-5
B, D = 6, 8


@pytest.fixture(autouse=True)
def _torch_state_kept():
    """Each test leaves torch's global RNG and thread count as found."""
    rng, threads = torch.get_rng_state(), torch.get_num_threads()
    yield
    assert torch.equal(torch.get_rng_state(), rng)
    assert torch.get_num_threads() == threads


def _rows(rng, n=B, d=D, normalize=True, positive=False):
    a = rng.standard_normal((n, d)).astype(np.float32)
    if positive:
        a = np.abs(a)
    if normalize:
        a /= np.linalg.norm(a, axis=1, keepdims=True)
    return a


def _compare(jax_fn, torch_fn, inputs, grad=True, rel_l2=()):
    """Value and gradient of both packages' functions of `inputs` (numpy
    arrays), each gradient with respect to every input: elementwise, or by
    its relative L2 error for the inputs numbered in `rel_l2`."""
    want = jax_fn(*[jnp.asarray(a) for a in inputs])
    ts = [torch.tensor(a, requires_grad=grad) for a in inputs]
    got = torch_fn(*ts)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    if not grad:
        return
    want_g = jax.grad(jax_fn, argnums=tuple(range(len(inputs))))(
        *[jnp.asarray(a) for a in inputs])
    got_g = torch.autograd.grad(got, ts, allow_unused=True)
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        g = np.zeros_like(inputs[i]) if g is None else g.numpy()
        w = np.asarray(w)
        if i in rel_l2:
            err = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert err <= GRAD_REL_L2, (i, err)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"gradient of input {i}")


def test_measures_are_the_jax_registry():
    assert sorted(tsim.SIMILARITIES) == sorted(SIMILARITIES._items)


@pytest.mark.parametrize("cost_style", ["sum", "mean"])
@pytest.mark.parametrize("max_violation", [False, True])
@pytest.mark.parametrize("direction", ["all", "t2v", "v2t"])
@pytest.mark.parametrize("measure", sorted(tsim.SIMILARITIES))
def test_triplet_matches_jax(measure, direction, max_violation, cost_style):
    rng = np.random.default_rng(
        [sorted(tsim.SIMILARITIES).index(measure), len(direction)])
    # jaccard reads non-negative (tag) vectors; cosine normalized rows
    s = _rows(rng, normalize=measure == "cosine",
              positive=measure == "jaccard")
    im = _rows(rng, normalize=measure == "cosine",
               positive=measure == "jaccard")
    args = (0.2, measure, max_violation, cost_style, direction)
    jcfg, tcfg = jt.TripletLossConfig(*args), tt.TripletLossConfig(*args)
    _compare(lambda a, b: jt.triplet_loss(a, b, jcfg),
             lambda a, b: tt.triplet_loss(a, b, tcfg), (s, im))


def test_triplet_masks_the_diagonal():
    """Identical embeddings: every positive scores as its negatives do, so
    only the masked diagonal keeps the loss from counting the margin B
    more times."""
    x = _rows(np.random.default_rng(3))
    got = tt.triplet_loss(torch.tensor(x), torch.tensor(x))
    want = jt.triplet_loss(jnp.asarray(x), jnp.asarray(x))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def _teacher(rng):
    """Teacher values with exact zeros and negatives (kl's where)."""
    t = rng.standard_normal((B, D)).astype(np.float32)
    t[0, :3] = 0.0
    return t


@pytest.mark.parametrize("reduction", ["sum", "mean"])
@pytest.mark.parametrize("name", ["mse_distill", "kl_distill"])
def test_distill_matches_jax(name, reduction):
    rng = np.random.default_rng(5)
    student = rng.standard_normal((B, D)).astype(np.float32)
    _compare(lambda s, t: getattr(jd, name)(s, t, reduction),
             lambda s, t: getattr(td, name)(s, t, reduction),
             (student, _teacher(rng)))


def test_kl_distill_gradient_is_finite_at_zero_targets():
    t = torch.zeros((2, 3), requires_grad=True)
    s = torch.ones((2, 3), requires_grad=True)
    for g in torch.autograd.grad(td.kl_distill(s, t), (s, t)):
        assert torch.isfinite(g).all()


def test_huber_matches_jax():
    rng = np.random.default_rng(6)
    a = 2 * rng.standard_normal((B, D)).astype(np.float32)
    b = rng.standard_normal((B, D)).astype(np.float32)
    _compare(lambda x, y: jnp.sum(jd.huber(x, y) * jnp.arange(D)),
             lambda x, y: torch.sum(td.huber(x, y) * torch.arange(D)),
             (a, b))


def _well_conditioned(rng):
    """(vid, cap) whose product is U diag(3, 2.5, ..., 0.5) V^T: distinct
    singular values well away from 0, so the singular vectors are defined
    up to their signs."""
    u, _ = np.linalg.qr(rng.standard_normal((B, B)))
    v, _ = np.linalg.qr(rng.standard_normal((B, B)))
    sv = np.linspace(3.0, 0.5, B)
    vid = np.zeros((B, D), np.float32)
    cap = np.zeros((B, D), np.float32)
    vid[:, :B] = u * sv[None, :]
    cap[:, :B] = v
    return vid, cap


def _similarity_inputs(kind, rng):
    if kind == "svd-well-conditioned":
        vid, cap = _well_conditioned(rng)
        svid, scap = _well_conditioned(rng)
        return vid, cap, svid, scap
    return tuple(_rows(rng) for _ in range(4))


SIMILARITY_CASES = [(None, "sum"), (None, "mean"), ("diag", "sum"),
                    ("maxdiag", "sum"), ("adapt", "sum"), ("svd", "sum"),
                    ("svd", "mean"), ("svd-well-conditioned", "sum")]


@pytest.mark.parametrize("kind,reduction", SIMILARITY_CASES,
                         ids=[f"{k}-{r}" for k, r in SIMILARITY_CASES])
def test_similarity_distill_matches_jax(kind, reduction):
    rng = np.random.default_rng(7)
    inputs = _similarity_inputs(kind, rng)
    stype = kind.split("-")[0] if kind else None
    if stype == "adapt":
        # the learned mask's matrix: pa1 on the diagonal, pa2 off it
        eye = np.eye(B, dtype=np.float32)
        inputs += (1.3 * eye + 0.7 * (1 - eye),)
    _compare(lambda *a: jd.similarity_distill(
                 *a[:4], stype, adapt_weight=a[4] if len(a) > 4 else None,
                 reduction=reduction),
             lambda *a: td.similarity_distill(
                 *a[:4], stype, adapt_weight=a[4] if len(a) > 4 else None,
                 reduction=reduction), inputs,
             rel_l2=range(4) if stype == "svd" else ())


@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_similarity_distill_eig_value_without_gradient(reduction):
    rng = np.random.default_rng(8)
    inputs = _similarity_inputs("eig", rng)
    _compare(lambda *a: jd.similarity_distill(*a, "eig",
                                              reduction=reduction),
             lambda *a: td.similarity_distill(*a, "eig",
                                              reduction=reduction),
             inputs, grad=False)
    want_g = jax.grad(lambda *a: jd.similarity_distill(*a, "eig"),
                      argnums=(0, 1, 2, 3))(*map(jnp.asarray, inputs))
    assert not any(np.asarray(g).any() for g in want_g)
    ts = [torch.tensor(a, requires_grad=True) for a in inputs]
    assert not td.similarity_distill(*ts, "eig").requires_grad


def test_adaptive_similarity_loss_matches_jax():
    rng = np.random.default_rng(9)
    embs = tuple(_rows(rng) for _ in range(4))
    eye = np.eye(B, dtype=np.float32)
    mask = 1.3 * eye + 0.7 * (1 - eye)
    _compare(jd.adaptive_similarity_loss, td.adaptive_similarity_loss,
             embs + (mask,), rel_l2=range(4))
