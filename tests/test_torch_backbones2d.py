"""The port's per-frame and light 3D backbones against the JAX package's,
on the CPU at a small size: TSM and TSN (stage_blocks (1, 1, 1, 1), base
8), TIN (plain at base 8, mmaction's ResNetTIN at base 16 so that each
block's interlaced channels split in four), MobileNetV2-TSM (three narrow
stages), TANet (base 8), C3D (fc 32; mmaction's exact head at its
smallest input, 16x96²) and R(2+1)D (base 8); 4 frames of 32² unless
said.

One state dict drawn from a numpy seed loads into the port as it is and
into the JAX package through the family's convert/torch_import.py
importer (convert_tsm, convert_tin, convert_mobilenetv2_tsm,
convert_tanet, convert_c3d, convert_r2plus1d), or, for the plain TIN that
no importer reads, through the port's convert/from_jax.py.

* Eval forward: features within FWD_TOL (1e-5) of the largest, f32.
* Train forward: features within TRAIN_TOL (1e-4: BatchNorm over the
  last stage's 1x1 maps of 12 frames normalises by the spread of 12
  values, and JAX's f32 variance E[x²] - E[x]² loses digits there), every
  running statistic after it within STATS_TOL (1e-5) of its tensor's
  largest magnitude; in float64 in both packages (jax.enable_x64) the
  features within F64_TOL (1e-9): the same arithmetic.
* The port's converters against the importers, both directions exact.
* The functional pieces alone: temporal_shift (frame t+1 into the first
  fold), tin_shift (frame t - shift, zero out of range), linear_sampler
  with its gradient to the offset, conv2plus1d_mid.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu.convert import torch_import as ti
from cross_modal_video_engine_tpu.models import backbones2d as jb
from cross_modal_video_engine_tpu.models import tanet as jta
from cross_modal_video_engine_tpu.models import tin_mobilenet as jtin
from cross_modal_video_engine_tpu_torch import convert as tconv
from cross_modal_video_engine_tpu_torch.models import backbones2d as tb
from cross_modal_video_engine_tpu_torch.models import tanet as tta
from cross_modal_video_engine_tpu_torch.models import tin_mobilenet as ttin
from test_torch_resnet3d import japply, random_conv_state_dict
from torch_parity import max_rel

FWD_TOL = 1e-5               # of the largest feature, f32
TRAIN_TOL = 1e-4             # the same in train mode
F64_TOL = 1e-9
STATS_TOL = 1e-5             # of each statistic's largest magnitude
T = 4
MOBILE = dict(stages=((1, 8, 1, 1), (6, 8, 2, 2), (6, 16, 2, 2)),
              last_channels=32)


def _tin_import(sd, cfg):
    """The plain TIN has no importer: the port's converter."""
    tm = ttin.TINResNet(ttin.TINConfig(**dict(
        cfg.__dict__, num_segments=T)), device="meta")
    return tconv.conv_recognizer_variables_to_jax(
        {k[len("backbone."):]: v for k, v in sd.items()}, tm)


def _c3d_import(sd, _cfg):
    return ti.convert_c3d(sd)


# name: (port class, port config or kwargs, JAX class, JAX config or
# kwargs, importer, (frames, size, batch))
FAMILIES = {
    "tsm": (tb.TSMResNet, tb.TSMConfig(stage_blocks=(1, 1, 1, 1),
                                       base_channels=8),
            jb.TSMResNet, jb.TSMConfig(stage_blocks=(1, 1, 1, 1),
                                       base_channels=8),
            ti.convert_tsm, (T, 32, 2)),
    "tsn": (tb.TSMResNet, tb.TSMConfig(stage_blocks=(1, 2, 1, 1),
                                       base_channels=8, shift_div=0),
            jb.TSMResNet, jb.TSMConfig(stage_blocks=(1, 2, 1, 1),
                                       base_channels=8, shift_div=0),
            ti.convert_tsm, (T, 32, 2)),
    "tin": (ttin.TINResNet, ttin.TINConfig(stage_blocks=(1, 1, 1, 1),
                                           base_channels=8, num_segments=T),
            jtin.TINResNet, jtin.TINConfig(stage_blocks=(1, 1, 1, 1),
                                           base_channels=8),
            _tin_import, (T, 32, 2)),
    "tin_exact": (ttin.TINResNetExact, ttin.TINExactConfig(
        stage_blocks=(1, 1, 1, 1), base_channels=16, num_segments=T),
        jtin.TINResNetExact, jtin.TINExactConfig(
            stage_blocks=(1, 1, 1, 1), base_channels=16, num_segments=T),
        ti.convert_tin, (T, 32, 2)),
    "mobilenetv2_tsm": (ttin.MobileNetV2TSM, ttin.MobileNetV2TSMConfig(
        **MOBILE), jtin.MobileNetV2TSM, jtin.MobileNetV2TSMConfig(**MOBILE),
        ti.convert_mobilenetv2_tsm, (T, 32, 2)),
    "tanet": (tta.TANet, tta.TANetConfig(stage_blocks=(1, 1, 1, 1),
                                         base_channels=8, num_segments=T),
              jta.TANet, jta.TANetConfig(stage_blocks=(1, 1, 1, 1),
                                         base_channels=8),
              ti.convert_tanet, (T, 32, 2)),
    "c3d": (tb.C3D, dict(fc_dim=32), jb.C3D, dict(fc_dim=32), _c3d_import,
            (8, 32, 2)),
    "c3d_exact": (tb.C3D, dict(fc_dim=16, exact_head=True), jb.C3D,
                  dict(fc_dim=16, exact_head=True), _c3d_import,
                  (16, 96, 1)),
    "r2plus1d": (tb.R2Plus1D, tb.R2Plus1DConfig(stage_blocks=(1, 1, 1, 1),
                                                base_channels=8),
                 jb.R2Plus1D, jb.R2Plus1DConfig(stage_blocks=(1, 1, 1, 1),
                                                base_channels=8),
                 ti.convert_r2plus1d, (8, 32, 2)),
}
# the JAX classes' and converters' names of each port family
FAMILY_FNS = {"tsm": "tsm", "tsn": "tsm", "tin": "tin",
              "tin_exact": "tin_exact", "mobilenetv2_tsm": "mobilenetv2_tsm",
              "tanet": "tanet", "r2plus1d": "r2plus1d"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    """One torch thread, and torch's global RNG and thread count left as
    found (tests/test_stgcn_conversion.py draws from the global RNG)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


def _build(cls, cfg, device="cpu"):
    return cls(**cfg, device=device) if isinstance(cfg, dict) \
        else cls(cfg, device=device)


def backbone_pair(name: str, seed: int = 3):
    """(port backbone with a seeded state dict, the state dict, the JAX
    backbone, its variables through the importer)."""
    tcls, tcfg, jcls, jcfg, importer, _ = FAMILIES[name]
    tm = _build(tcls, tcfg)
    sd = random_conv_state_dict(tm, seed)
    tm.load_state_dict(sd)
    jm = jcls(**jcfg) if isinstance(jcfg, dict) else jcls(jcfg)
    variables = importer({"backbone." + k: v for k, v in sd.items()}, jcfg)
    return tm, sd, jm, variables


def clips(name: str, batch=None, seed: int = 1) -> np.ndarray:
    t, size, b = FAMILIES[name][-1]
    return np.random.default_rng(seed).standard_normal(
        (batch or b, t, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_eval_forward_matches_jax(name):
    tm, _, jm, variables = backbone_pair(name)
    x = clips(name)
    want = np.asarray(japply(jm, variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert got.shape[-1] == tm.feat_dim
    assert max_rel(got, want) <= FWD_TOL


@pytest.mark.parametrize("name", [n for n in FAMILIES
                                  if not n.startswith("c3d")])
def test_train_forward_and_statistics_match_jax(name):
    tm, _, jm, variables = backbone_pair(name)
    x = clips(name, batch=3)
    want, mutated = japply(jm, variables, jnp.asarray(x), train=True,
                           mutable=["batch_stats"])
    tm.train()
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert max_rel(got, np.asarray(want)) <= TRAIN_TOL
    stats = tconv.conv_recognizer_state_dict_from_jax(
        {"params": variables["params"],
         "batch_stats": jax.tree.map(np.asarray, mutated["batch_stats"])},
        tm)
    moved = 0
    for key, b in tm.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            assert max_rel(b.numpy(), stats[key].numpy()) <= STATS_TOL, key
            moved += 1
        if key.endswith("num_batches_tracked"):
            assert int(b) == 1, key
    assert moved


@pytest.mark.parametrize("name", ["tsn", "tin_exact", "tanet"])
def test_train_forward_float64(name):
    tm, sd, jm, variables = backbone_pair(name)
    tm = tm.double()
    tm.load_state_dict(sd)
    x = clips(name, batch=3)
    tm.train()
    got = tm(torch.from_numpy(x).double()).detach().numpy()
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                           variables)
        want, _ = japply(jm, v64, jnp.asarray(x, jnp.float64), train=True,
                         mutable=["batch_stats"])
        want = np.asarray(want)
    assert want.dtype == np.float64
    assert max_rel(got, want) <= F64_TOL


@pytest.mark.parametrize("name", list(FAMILIES))
def test_converters_invert_the_importers(name):
    tm, sd, _, variables = backbone_pair(name)
    got = tconv.conv_recognizer_variables_to_jax(sd, tm)
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, variables))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(a, np.asarray(b))
    back = tconv.conv_recognizer_state_dict_from_jax(variables, tm)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    if name in FAMILY_FNS:          # the family's own pair of functions
        tcfg = FAMILIES[name][1]
        fam = FAMILY_FNS[name]
        back = getattr(tconv, f"{fam}_state_dict_from_jax")(variables, tcfg)
        assert all(torch.equal(back[k], v) for k, v in sd.items())
        again = getattr(tconv, f"{fam}_variables_to_jax")(sd, tcfg)
        assert jax.tree.structure(again) == jax.tree.structure(got)


# -- the functional pieces ----------------------------------------------------

def test_temporal_shift_matches_jax():
    """The first fold at t holds frame t+1 (the code, not the JAX
    docstring's words), the second frame t-1, zeros at the ends."""
    x = np.random.default_rng(5).standard_normal(
        (2, 5, 3, 3, 16)).astype(np.float32)
    want = np.asarray(jb.temporal_shift(jnp.asarray(x), 8))
    got = tb.temporal_shift(torch.from_numpy(x.transpose(0, 1, 4, 2, 3)), 8)
    np.testing.assert_array_equal(got.numpy().transpose(0, 1, 3, 4, 2), want)
    np.testing.assert_array_equal(want[:, 0, ..., :2], x[:, 1, ..., :2])
    np.testing.assert_array_equal(want[:, 1, ..., 2:4], x[:, 0, ..., 2:4])
    assert not want[:, -1, ..., :2].any() and not want[:, 0, ..., 2:4].any()
    np.testing.assert_array_equal(want[..., 4:], x[..., 4:])


def test_tin_shift_matches_jax():
    rng = np.random.default_rng(6)
    data = rng.standard_normal((3, 6, 8, 5)).astype(np.float32)
    shift = rng.integers(-7, 8, (3, 4)).astype(np.int32)
    want = np.asarray(jtin.tin_shift(jnp.asarray(data), jnp.asarray(shift)))
    got = ttin.tin_shift(torch.from_numpy(data),
                         torch.from_numpy(shift).long()).numpy()
    np.testing.assert_array_equal(got, want)
    # out[n, t, c] = data[n, t - shift, c]: a shift of 2 delays by 2
    one = ttin.tin_shift(torch.from_numpy(data[:1]),
                         torch.full((1, 4), 2)).numpy()
    np.testing.assert_array_equal(one[0, 2:], data[0, :-2])
    assert not one[0, :2].any()


def test_linear_sampler_and_its_offset_gradient_match_jax():
    """The blend of the floor and floor + 1 shifts; the offset's gradient
    comes through the fractional weight alone."""
    rng = np.random.default_rng(7)
    data = rng.standard_normal((2, 5, 8, 2, 3)).astype(np.float32)
    offset = np.array([[0.3, -1.6, 2.25, -0.5], [1.7, 0.0, -2.4, 0.9]],
                      np.float32)
    ct = rng.standard_normal(data.shape).astype(np.float32)

    def jfun(d, o):
        return (jtin.linear_sampler(d, o) * ct).sum()

    want = np.asarray(jtin.linear_sampler(jnp.asarray(data),
                                          jnp.asarray(offset)))
    gd, go = jax.grad(jfun, argnums=(0, 1))(jnp.asarray(data),
                                            jnp.asarray(offset))
    d = torch.from_numpy(data).requires_grad_(True)
    o = torch.from_numpy(offset).requires_grad_(True)
    got = ttin.linear_sampler(d, o)
    (got * torch.from_numpy(ct)).sum().backward()
    assert max_rel(got.detach().numpy(), want) <= 1e-6
    assert max_rel(d.grad.numpy(), np.asarray(gd)) <= 1e-6
    assert max_rel(o.grad.numpy(), np.asarray(go)) <= 1e-5
    assert np.abs(np.asarray(go)).min() > 0


def test_linear_sampler_offset_gradient_keeps_its_f32_digits():
    """Neighbouring frames nearly equal (100 + 1e-3 noise; the gradient
    zero on the edge frames, where a shift reads the zero padding): the
    offset's f32 gradient within 1e-4 of float64's largest, where the
    blend written w0 d0 + (1 - w0) d1 loses it to cancellation."""
    rng = np.random.default_rng(11)
    data = (100.0 + 1e-3 * rng.standard_normal((2, 6, 8, 2, 3))).astype(
        np.float32)
    offset = np.array([[0.3, -0.6, 0.25, -0.5], [0.7, -0.1, 0.4, -0.9]],
                      np.float32)
    ct = rng.standard_normal(data.shape)
    ct[:, [0, -1]] = 0.0

    def offset_grad(fn, dtype):
        o = torch.from_numpy(offset).to(dtype).requires_grad_(True)
        out = fn(torch.from_numpy(data).to(dtype), o)
        (out * torch.from_numpy(ct).to(dtype)).sum().backward()
        return o.grad.double().numpy()

    def blend_apart(d, o):
        n, t, f, h, w = d.shape
        flat = d.reshape(n, t, f, h * w)
        floor = torch.floor(o)
        d0 = ttin.tin_shift(flat, floor.long())
        d1 = ttin.tin_shift(flat, floor.long() + 1)
        w0 = torch.repeat_interleave(1.0 - (o - floor), f // o.shape[1], 1)
        w0 = w0[:, None, :, None]
        return (w0 * d0 + (1.0 - w0) * d1).reshape(d.shape)

    truth = offset_grad(ttin.linear_sampler, torch.float64)
    assert max_rel(offset_grad(ttin.linear_sampler, torch.float32),
                   truth) <= 1e-4
    assert max_rel(offset_grad(blend_apart, torch.float32), truth) > 1e-3


@pytest.mark.parametrize("shape", [(3, 64, 3, 7, 7), (64, 64, 3, 3, 3),
                                   (64, 128, 1, 1, 1), (128, 256, 3, 3, 3),
                                   (5, 7, 3, 1, 3)])
def test_conv2plus1d_mid_is_the_integer_formula(shape):
    assert tb.conv2plus1d_mid(*shape) == jb.conv2plus1d_mid(*shape)
    assert tb.conv2plus1d_mid(3, 64, 3, 7, 7) == 83     # not 45


def test_r2plus1d_factorises_the_downsample():
    tm, sd, _, _ = backbone_pair("r2plus1d")
    assert "layer2.0.downsample.conv.conv_s.weight" in sd
    assert tm.layer2[0].downsample.conv.conv_t.stride == (2, 1, 1)
    assert tm.layer2[0].downsample.conv.conv_s.stride == (1, 2, 2)
