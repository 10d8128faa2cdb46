"""Gradients of the port's five kernel entry points against `jax.grad` of
the JAX functions (whose custom_vjps differentiate the plain `_*_ref`
math), for x and every weight, in f32 on the same numpy inputs.

On the CPU the port's entry points run their plain versions, whose own
autograd is the gradient.  On a card the forward is a kernel and the
backward is `_PlainBackward`, which recomputes the plain version; that
Function is exercised here by calling it directly with the plain version
as its forward.

Tolerance 2e-4 absolute and relative, the JAX gradient tests' own: both
sides differentiate the same f32 math, summed in different orders."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cross_modal_video_engine_tpu.ops.attention_sublayer as jasl
import cross_modal_video_engine_tpu.ops.flash_attention as jfa
import cross_modal_video_engine_tpu_torch.ops.attention_sublayer as tasl
import cross_modal_video_engine_tpu_torch.ops.flash_attention as tfa

from torch_parity import interpret_pallas

TOL = 2e-4
B, L, D, H = 8, 10, 32, 4     # 8 x 10 rows: a chunk the JAX kernel takes


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    """One torch thread (the lane runs several xdist workers), and torch's
    global RNG and thread count left as found for the other test files
    this worker runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    interpret_pallas(monkeypatch)


def _attn_w(rng, d=D):
    w = [1 + 0.1 * rng.standard_normal(d), 0.1 * rng.standard_normal(d)]
    for _ in range(4):
        w += [rng.standard_normal((d, d)) * d ** -0.5,
              0.02 * rng.standard_normal(d)]
    return [a.astype(np.float32) for a in w]


def _mlp_w(rng, d=D):
    return [a.astype(np.float32) for a in (
        1 + 0.1 * rng.standard_normal(d), 0.1 * rng.standard_normal(d),
        rng.standard_normal((d, 4 * d)) * d ** -0.5,
        0.02 * rng.standard_normal(4 * d),
        rng.standard_normal((4 * d, d)) * (4 * d) ** -0.5,
        0.02 * rng.standard_normal(d))]


def _to_torch(arrays):
    """Leaves that require grad: x as it is, then the parameters with
    matrices in torch Linear layout."""
    x, params = arrays[0], arrays[1:]
    return [torch.from_numpy(x).requires_grad_()] + [
        torch.from_numpy(np.ascontiguousarray(a.T if a.ndim == 2 else a))
        .requires_grad_() for a in params]


def _jax_grads(fn, arrays, weight=None):
    """d sum(sin(fn(*a)) * weight) / d a for every a."""
    def loss(*a):
        y = jnp.sin(fn(*a))
        return jnp.sum(y if weight is None else y * weight)
    return jax.grad(loss, argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])


def _torch_grads(fn, leaves, weight=None):
    y = torch.sin(fn(*leaves))
    loss = (y if weight is None else y * torch.from_numpy(weight)).sum()
    return torch.autograd.grad(loss, leaves)


def _same(got, want, arrays, first_is_x=True):
    assert len(got) == len(want) == len(arrays)
    for i, (g, w, a) in enumerate(zip(got, want, arrays)):
        g = g.numpy()
        if a.ndim == 2 and first_is_x and i > 0:
            g = g.T                         # Linear (out, in) -> (in, out)
        np.testing.assert_allclose(g, np.asarray(w), rtol=TOL, atol=TOL,
                                   err_msg=f"input {i}")


def _through_function(plain, leaves, weight=None):
    """The card's gradient route on the CPU: `_PlainBackward` with the
    plain version standing in for the kernel launch."""
    return _torch_grads(
        lambda *a: tasl._PlainBackward.apply(plain, plain, *a), leaves,
        weight)


CASES = {}


def _case(name):
    def register(build):
        CASES[name] = build
        return build
    return register


@_case("fused_attention_sublayer")
def _rank3():
    rng = np.random.default_rng(31)
    lp, valid = 16, 13
    arrays = [0.5 * rng.standard_normal((B, lp, D)).astype(np.float32)] \
        + _attn_w(rng)
    weight = np.zeros((B, lp, 1), np.float32)
    weight[:, :valid] = 1               # pad rows are outside the contract
    kw = dict(heads=H, valid_len=valid, causal=True)
    return (arrays, weight,
            lambda *a: jasl.fused_attention_sublayer(*a, **kw),
            lambda *a: tasl.fused_attention_sublayer(*a, **kw),
            lambda *a: tasl._attn_ref(*a, **kw))


@_case("fused_attention_sublayer_compact")
def _compact():
    rng = np.random.default_rng(32)
    arrays = [0.5 * rng.standard_normal((B * L, D)).astype(np.float32)] \
        + _attn_w(rng)
    kw = dict(heads=H, seq_len=L, causal=False)
    return (arrays, None,
            lambda *a: jasl.fused_attention_sublayer_compact(
                *a, g=jasl._compact_chunk(B, L), **kw),
            lambda *a: tasl.fused_attention_sublayer_compact(*a, **kw),
            lambda *a: tasl._attn_ref_flat(*a, **kw))


@_case("fused_mlp_sublayer")
def _mlp():
    rng = np.random.default_rng(33)
    arrays = [0.5 * rng.standard_normal((3, 7, D)).astype(np.float32)] \
        + _mlp_w(rng)
    return (arrays, None, jasl.fused_mlp_sublayer, tasl.fused_mlp_sublayer,
            tasl._mlp_ref)


@_case("fused_block_sublayer_compact")
def _block():
    rng = np.random.default_rng(34)
    arrays = [0.5 * rng.standard_normal((B * L, 64)).astype(np.float32)] \
        + _attn_w(rng, 64) + _mlp_w(rng, 64)
    kw = dict(heads=H, seq_len=L, causal=True)
    return (arrays, None,
            lambda *a: jasl.fused_block_sublayer_compact(
                *a, g=jasl._compact_chunk(B, L), **kw),
            lambda *a: tasl.fused_block_sublayer_compact(*a, **kw),
            lambda *a: tasl._block_ref_flat(*a, **kw))


@_case("flash_attention")
def _flash():
    rng = np.random.default_rng(35)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((2, 3, 24, 16), (2, 3, 40, 16), (2, 3, 40, 16))]
    return (arrays, None,
            lambda q, k, v: jfa.flash_attention(q, k, v, 0.25, True),
            lambda q, k, v: tfa.flash_attention(q, k, v, 0.25, True),
            lambda q, k, v: tfa._reference_attention(q, k, v, 0.25, True))


def _leaves(name, arrays):
    if name == "flash_attention":        # q, k, v: no layout change
        return [torch.from_numpy(a).requires_grad_() for a in arrays]
    return _to_torch(arrays)


@pytest.mark.parametrize("name", list(CASES))
def test_entry_point_gradients_match_jax(name):
    arrays, weight, jax_fn, torch_fn, _plain = CASES[name]()
    want = _jax_grads(jax_fn, arrays, weight)
    got = _torch_grads(torch_fn, _leaves(name, arrays), weight)
    _same(got, want, arrays, first_is_x=name != "flash_attention")


@pytest.mark.parametrize("name", list(CASES))
def test_plain_backward_function_gradients_match_jax(name):
    arrays, weight, jax_fn, _torch_fn, plain = CASES[name]()
    want = _jax_grads(jax_fn, arrays, weight)
    got = _through_function(plain, _leaves(name, arrays), weight)
    _same(got, want, arrays, first_is_x=name != "flash_attention")


def test_plain_backward_skips_inputs_that_need_no_gradient():
    rng = np.random.default_rng(36)
    arrays = [0.5 * rng.standard_normal((5, D)).astype(np.float32)] \
        + _mlp_w(rng)
    leaves = _to_torch(arrays)
    for t in leaves[3:]:
        t.requires_grad_(False)
    calls = []

    def plain(*a):
        calls.append((torch.is_grad_enabled(),
                      [t.requires_grad for t in a]))
        return tasl._mlp_ref(*a)

    out = tasl._PlainBackward.apply(plain, plain, *leaves)
    assert [c[0] for c in calls] == [False]      # the forward builds no graph
    out.sum().backward()
    assert calls[-1] == (True, [True, True, True, False, False, False, False])
    assert all(t.grad is not None for t in leaves[:3])
    assert all(t.grad is None for t in leaves[3:])


def test_launch_uses_the_function_only_when_a_gradient_is_asked_for():
    x = torch.zeros(3, 4)
    w = torch.zeros(4).requires_grad_()
    seen = []

    def launch(a, b):
        seen.append(torch.is_grad_enabled())
        return a + b

    assert tasl._launch(launch, launch, x, w).grad_fn is not None
    with torch.no_grad():
        assert tasl._launch(launch, launch, x, w).grad_fn is None
    assert tasl._launch(launch, launch, x, w.detach()).grad_fn is None
    # inside the Function the forward runs with grad mode off
    assert seen == [False, False, True]
