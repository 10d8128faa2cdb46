"""The port's Video Swin (models/swin3d.py) against the JAX package's, on
the CPU at a small size: embed 8, depths (2, 2), heads (1, 2), window
(2, 3, 3), patch (2, 4, 4), videos of 6x26x22 (batch 3).

That grid exercises every pin: 26 and 22 do not divide the patch (flax's
'SAME' pad), stage 0's 3x7x6 grid needs per-block padding to the window
in depth and height, its odd height goes through PatchMerging's pad,
each stage has an unshifted and a shifted block, and stage 1's 3x4x3
grid pads again.

* The window functions, the relative-position index and the shifted
  window mask equal the JAX ones.
* Forward (a BackboneClassifier's eval logits) within FWD_TOL (1e-5) of
  the largest, f32.
* The converter is the importer: the port's state dict through
  `conv_recognizer_variables_to_jax` is exactly `convert_swin3d`'s tree,
  and `swin3d_state_dict_from_jax` inverts it.
* The relative-position tables follow the input's clipped windows, and a
  checkpoint's tables load at their own size.
* One `make_cls_train_step` against JAX's, f32 and bf16=True (the bounds
  of tests/torch_transformer_parity.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu.convert import torch_import as ti
from cross_modal_video_engine_tpu.models import recognizer as jrec
from cross_modal_video_engine_tpu.models import swin3d as js
from cross_modal_video_engine_tpu_torch import convert as tconv
from cross_modal_video_engine_tpu_torch.models import recognizer as trec
from cross_modal_video_engine_tpu_torch.models import swin3d as ts
from cross_modal_video_engine_tpu_torch.models.flax_nn import same_pads
import torch_transformer_parity as P
from torch_parity import max_rel

FWD_TOL, CLASSES = 1e-5, 5
CFG = dict(embed_dim=8, depths=(2, 2), num_heads=(1, 2),
           window_size=(2, 3, 3), patch_size=(2, 4, 4))
SHAPE = (6, 26, 22)


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


def videos(batch=3, seed=1, shape=SHAPE):
    return np.random.default_rng(seed).standard_normal(
        (batch, *shape, 3)).astype(np.float32)


def pair(seed=5):
    tm = trec.BackboneClassifier(
        ts.Swin3D(ts.Swin3DConfig(**CFG), "cpu", SHAPE), CLASSES,
        dropout_ratio=0.0)
    tm.load_state_dict(P.seeded_state_dict(tm, seed))
    jm = jrec.BackboneClassifier(js.Swin3D(js.Swin3DConfig(**CFG)), CLASSES,
                                 dropout_ratio=0.0)
    return tm, jm


def test_window_functions_match_jax():
    x = np.random.default_rng(0).standard_normal((2, 4, 6, 9, 5)).astype(
        np.float32)
    w = (2, 3, 3)
    part = ts.window_partition(torch.tensor(x), w)
    np.testing.assert_array_equal(
        part.numpy(), np.asarray(js.window_partition(jnp.asarray(x), w)))
    np.testing.assert_array_equal(
        ts.window_reverse(part, w, 2, 4, 6, 9).numpy(), x)
    for win in ((2, 3, 3), (1, 7, 7), (8, 7, 7)):
        np.testing.assert_array_equal(ts.relative_position_index(win),
                                      js.relative_position_index(win))
    for dims, win, shift in (((4, 9, 6), (2, 3, 3), (1, 1, 1)),
                             ((4, 6, 6), (2, 3, 3), (0, 1, 1)),
                             ((8, 14, 14), (4, 7, 7), (2, 3, 3))):
        np.testing.assert_array_equal(
            ts.shifted_window_mask(dims, win, shift),
            js.shifted_window_mask(dims, win, shift))


def test_same_padding_is_flax_s():
    assert same_pads(26, 4, 4) == (1, 1) and same_pads(22, 4, 4) == (1, 1)
    assert same_pads(24, 4, 4) == (0, 0) and same_pads(7, 3, 2) == (1, 1)
    assert same_pads(5, 2, 2) == (0, 1)


def test_forward_matches_jax():
    tm, jm = pair()
    x = videos()
    variables = P.jax_variables(tm)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert max_rel(got, want) <= FWD_TOL
    # the pins this grid reaches: per-block padding, odd merge, shifts
    assert ts.stage_windows(tm.backbone.cfg, SHAPE) == ((2, 3, 3),) * 2


def test_converter_is_the_importer():
    tm, _ = pair(seed=6)
    sd = tm.state_dict()
    ours = P.jax_variables(tm)
    theirs = ti.convert_swin3d({k: v.numpy() for k, v in sd.items()},
                               js.Swin3DConfig(**CFG))
    assert jax.tree.structure(ours) == jax.tree.structure(theirs)
    assert all(jax.tree.leaves(jax.tree.map(np.array_equal, ours, theirs)))
    back = tconv.conv_recognizer_state_dict_from_jax(theirs, tm)
    assert all(torch.equal(back[k], v) for k, v in sd.items())
    bb = {k[len("backbone."):]: v for k, v in sd.items()
          if k.startswith("backbone.")}
    cfg = ts.Swin3DConfig(**CFG)
    tree = tconv.swin3d_variables_to_jax(bb, cfg)
    back = tconv.swin3d_state_dict_from_jax(tree, cfg)
    assert all(torch.equal(back[k], v) for k, v in bb.items())


def test_tables_follow_the_clipped_windows():
    cfg = ts.Swin3DConfig(**dict(CFG, window_size=(8, 7, 7)))
    small = ts.Swin3D(cfg, "cpu", (4, 32, 32))    # grids 2x8x8 and 2x4x4
    assert ts.stage_windows(cfg, (4, 32, 32)) == ((2, 7, 7), (2, 4, 4))
    rows = [blk.attn.relative_position_bias_table.shape[0]
            for st in small.layers for blk in st.blocks]
    assert rows == [3 * 13 * 13] * 2 + [3 * 7 * 7] * 2
    jv = jax.eval_shape(js.Swin3D(cfg).init, jax.random.key(0),
                        jnp.zeros((1, 4, 32, 32, 3)))["params"]
    assert jv["stage1_block0"]["attn"]["rel_pos_bias"].shape == (147, 2)
    # a model built without the input's shape takes the checkpoint's
    # tables at their own size, and refuses videos its tables don't fit
    unsized = ts.Swin3D(cfg, "cpu")
    unsized.load_state_dict(P.seeded_state_dict(small, 2))
    with torch.no_grad():
        a = unsized(torch.from_numpy(videos(1, 3, (4, 32, 32))))
        b = small.load_state_dict(unsized.state_dict())
        assert not b.missing_keys
        assert torch.equal(a, small(torch.from_numpy(videos(1, 3,
                                                            (4, 32, 32)))))
        with pytest.raises(ValueError, match="input_shape"):
            unsized(torch.from_numpy(videos(1, 3, (16, 64, 64))))


@pytest.fixture(scope="module")
def runs():
    tm, jm = pair(seed=7)
    x, lab = videos(seed=8), np.array([0, 2, 4])
    return (P.steps(tm, jm, x, lab, bf16=False),
            P.steps(tm, jm, x, lab, bf16=True))


def test_f32_step_matches_jax(runs):
    P.check_f32_step(runs[0])


def test_bf16_step_matches_jax(runs):
    P.check_bf16_step(runs[1], runs[0])
