"""The port's checkpoint format against the JAX package's, on the CPU.

A checkpoint the JAX `save_checkpoint` writes loads in the port leaf for
leaf (f32, bf16, integer and scalar leaves); the port's msgpack writer
gives the bytes `flax.serialization.to_bytes` gives; a checkpoint the port
writes loads in the JAX `load_checkpoint` and gives the same file; chunked
arrays and malformed data; the port's checkpoint module needs neither
msgpack nor flax nor jax; and `restore_dual_encoding` on a JAX-written
LINAS checkpoint embeds as the JAX model does."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization

from fixtures import make_checkpoint, make_collection

from cross_modal_video_engine_tpu.cli import common as jcommon
from cross_modal_video_engine_tpu.models.dual_encoding import (
    make_text_batch as j_text_batch, make_video_batch as j_video_batch)
from cross_modal_video_engine_tpu.train import checkpoint as jckpt
from cross_modal_video_engine_tpu_torch.cli import common as tcommon
from cross_modal_video_engine_tpu_torch.io import flax_msgpack
from cross_modal_video_engine_tpu_torch.models.dual_encoding import (
    DualEncodingConfig, make_text_batch, make_video_batch)
from cross_modal_video_engine_tpu_torch.train import checkpoint as tckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _torch_state_kept():
    """Each test leaves torch's global RNG and thread count as found."""
    rng, threads = torch.get_rng_state(), torch.get_num_threads()
    yield
    assert torch.equal(torch.get_rng_state(), rng)
    assert torch.get_num_threads() == threads


def _trees():
    """name -> a variables-like tree of numpy leaves (bf16 as ml_dtypes)."""
    rng = np.random.default_rng(31)
    f32 = {"params": {"dense": {"kernel": rng.standard_normal((7, 5)).astype(
                          np.float32), "bias": np.zeros(5, np.float32)},
                      "embed": {"embedding": rng.standard_normal(
                          (300, 3)).astype(np.float32)}},
           "batch_stats": {"bn": {"mean": np.ones(5, np.float32),
                                  "var": np.full(5, 2.0, np.float32)}}}
    bf16 = {"params": {"w": rng.standard_normal((4, 6)).astype(
                ml_dtypes.bfloat16),
            "b": np.asarray([1.5, -2.25, 3e-3], ml_dtypes.bfloat16)}}
    mixed = {"step": np.int64(70000), "scale": np.float32(2.5),
             "flag": np.bool_(True), "ids": np.arange(-40, 40, dtype=np.int32),
             "u8": np.arange(256, dtype=np.uint8), "f16": np.ones(3, np.float16),
             "f64": np.linspace(0, 1, 5), "empty": np.zeros((0, 4), np.float32),
             "scalar": np.asarray(1.0, np.float32),
             "x" * 40: np.zeros(2, np.float32)}
    wide = {f"layer_{i}": {"w": np.full((i + 1,), i, np.float32)}
            for i in range(20)}
    return {"f32": f32, "bf16": bf16, "mixed": mixed, "wide": wide}


def _as_numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return leaf.numpy()
    return np.asarray(leaf)


def _assert_same_tree(got, want):
    assert jax.tree.structure(jax.tree.map(lambda x: 0, got)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, want))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        g = _as_numpy(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.reshape(-1).view(np.uint8),
                                      w.reshape(-1).view(np.uint8))


@pytest.mark.parametrize("name", ["f32", "bf16", "mixed", "wide"])
def test_jax_checkpoint_loads_leaf_for_leaf(tmp_path, name):
    tree = _trees()[name]
    jckpt.save_checkpoint(str(tmp_path), tree, DualEncodingConfig(),
                          {"epoch": 3})
    variables, config, meta = tckpt.load_checkpoint(str(tmp_path))
    assert meta == {"epoch": 3}
    assert config["visual_kernel_sizes"] == [2, 3, 4, 5]
    # the JAX save writes every leaf as an array (scalars as 0-d)
    _assert_same_tree(variables, jax.tree.map(np.asarray, tree))
    if name == "bf16":
        assert variables["params"]["w"].dtype == torch.bfloat16


def _flax_bytes(tree):
    return serialization.to_bytes(tree)


@pytest.mark.parametrize("name", ["f32", "bf16", "mixed", "wide"])
def test_writer_bytes_equal_flax(name):
    tree = _trees()[name]
    assert flax_msgpack.to_bytes(tree) == _flax_bytes(tree)


def test_writer_bytes_equal_flax_for_torch_and_python_leaves():
    """Torch tensors (bf16 too) write as the numpy arrays they hold; Python
    scalars, None, strings, sequences and complex as flax writes them."""
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    h = torch.tensor([1.0, -0.5, 2.0], dtype=torch.bfloat16)
    tree = {"t": t, "h": h, "i": 5, "neg": -300, "big": 2 ** 40, "f": 0.25,
            "none": None, "s": "name", "seq": [1, (2.0, "x")],
            "c": complex(1, -2), "b": False}
    want = dict(tree, t=t.numpy(), h=np.asarray(h.float().numpy(),
                                                ml_dtypes.bfloat16))
    assert flax_msgpack.to_bytes(tree) == _flax_bytes(want)
    back = flax_msgpack.restore(_flax_bytes(want))
    assert back["seq"] == {"0": 1, "1": {"0": 2.0, "1": "x"}}
    assert back["c"] == complex(1, -2) and back["none"] is None
    assert torch.equal(back["h"], h) and torch.equal(back["t"], t)


def test_numpy_scalar_ext_type_reads():
    """flax writes a numpy scalar as extension type 3; it reads as a 0-d
    tensor of its dtype."""
    data = _flax_bytes({"s": np.float32(2.5), "n": np.int16(-3),
                        "h": np.asarray(1.5, ml_dtypes.bfloat16)[()]})
    back = flax_msgpack.restore(data)
    assert back["s"].dtype == torch.float32 and back["s"].shape == ()
    assert float(back["s"]) == 2.5 and int(back["n"]) == -3
    assert back["h"].dtype == torch.bfloat16 and float(back["h"]) == 1.5
    assert flax_msgpack.to_bytes({"s": np.float32(2.5), "n": np.int16(-3),
                                  "h": np.asarray(1.5, ml_dtypes.bfloat16)[()]
                                  }) == data


def test_bf16_ext_payload_layout():
    """The layout the format documents: ext8, type 1, [shape, name, bin]."""
    data = flax_msgpack.to_bytes({"h": torch.ones(2, dtype=torch.bfloat16)})
    assert data == _flax_bytes({"h": jnp.ones((2,), jnp.bfloat16)})
    assert data[:1] == b"\x81" and data[3:13] == (
        b"\xc7\x12\x01\x93\x91\x02\xa8bfl")


def test_chunked_arrays_round_trip(monkeypatch):
    """Arrays past MAX_CHUNK_SIZE bytes are written as flax's chunked dict
    and reassembled on reading (the limit shrunk for the test)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
    a = np.arange(100, dtype=np.float32).reshape(4, 25)
    tree = {"big": a, "small": np.ones(3, np.float32)}
    data = serialization.to_bytes(tree)
    assert flax_msgpack.to_bytes(tree) == data
    assert flax_msgpack.to_bytes({"big": torch.from_numpy(a),
                                  "small": torch.ones(3)}) == data
    back = flax_msgpack.restore(data)
    np.testing.assert_array_equal(back["big"].numpy(), a)
    np.testing.assert_array_equal(
        serialization.msgpack_restore(flax_msgpack.to_bytes(tree))["big"], a)


@pytest.mark.parametrize("data,match", [
    (b"\x81\xa1k", "truncated"),
    (b"\x81\xa1k\xc7\x01\x05x", "extension type 5"),
    (b"\xc1", "starts no msgpack"),
    (b"\x90\x90", "bytes after"),
])
def test_malformed_data_raises(data, match):
    with pytest.raises(ValueError, match=match):
        flax_msgpack.restore(data)


def test_malformed_chunked_array_raises():
    data = flax_msgpack.to_bytes({"a": {flax_msgpack.CHUNKED: True,
                                        "shape": {"0": 2}}})
    with pytest.raises(ValueError, match="chunked"):
        flax_msgpack.restore(data)


@pytest.mark.parametrize("name", ["f32", "bf16", "mixed"])
def test_port_checkpoint_loads_in_jax_and_matches_its_file(tmp_path, name):
    """The port's save_checkpoint writes the file the JAX one writes for
    the same tree (keys sorted as jax.tree.map sorts them), and JAX's
    load_checkpoint reads it, with a template too."""
    tree = _trees()[name]
    tckpt.save_checkpoint(str(tmp_path / "port"), tree, DualEncodingConfig(),
                          {"epoch": 1})
    jckpt.save_checkpoint(str(tmp_path / "jax"), tree, DualEncodingConfig(),
                          {"epoch": 1})
    for f in ("params.msgpack", "config.json"):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes()
    variables, config, meta = jckpt.load_checkpoint(str(tmp_path / "port"))
    _assert_same_tree(variables, jax.tree.map(np.asarray, tree))
    restored, _, _ = jckpt.load_checkpoint(str(tmp_path / "port"),
                                           template=tree)
    _assert_same_tree(restored, tree)


def test_checkpoint_module_needs_no_msgpack_flax_or_jax(tmp_path):
    code = (
        "import sys, numpy as np, torch\n"
        "from cross_modal_video_engine_tpu_torch.train import checkpoint\n"
        f"p = {str(tmp_path)!r}\n"
        "tree = {'a': torch.ones(3, dtype=torch.bfloat16), 'b': np.arange(4)}\n"
        "checkpoint.save_checkpoint(p, tree, None, {'k': 1})\n"
        "v, c, m = checkpoint.load_checkpoint(p)\n"
        "assert torch.equal(v['a'], tree['a']) and m == {'k': 1}\n"
        "assert v['b'].tolist() == [0, 1, 2, 3]\n"
        "bad = [n for n in ('msgpack', 'flax', 'jax', "
        "'cross_modal_video_engine_tpu') if n in sys.modules]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_restore_dual_encoding_from_a_jax_checkpoint(tmp_path):
    """A LINAS checkpoint the JAX package writes, restored by the port,
    embeds videos and captions as the JAX model does."""
    root = str(tmp_path)
    info = make_collection(root)
    ckpt, cfg = make_checkpoint(root, info)
    jmodel, jstate = jcommon.restore_dual_encoding(ckpt)
    model, state = tcommon.restore_dual_encoding(ckpt, device="cpu")
    assert state["meta"] == {"epoch": 0} and not model.training
    assert state["config"].visual_kernel_sizes == cfg.visual_kernel_sizes
    rng = np.random.default_rng(32)
    frames = [rng.standard_normal((n, cfg.visual_feat_dim)).astype(np.float32)
              for n in (5, 9, 2)]
    ids = [[1, 5, 6, 2], [1, 4, 2], []]
    bows = rng.random((3, cfg.bow_vocab_size)).astype(np.float32)
    want_v = jmodel.apply(jstate["variables"], j_video_batch(frames, 8),
                          method="embed_vis_distill")
    want_t = jmodel.apply(jstate["variables"], j_text_batch(ids, bows, 8),
                          method="embed_txt_distill")
    with torch.no_grad():
        got_v = model.embed_vis_distill(make_video_batch(frames, 8, "cpu"))
        got_t = model.embed_txt_distill(make_text_batch(ids, bows, 8, "cpu"))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=0,
                               atol=1e-4)
