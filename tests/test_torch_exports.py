"""The port's export_model and export_yolo (cli/misc_tools.py) against the
JAX tools' StableHLO artifacts, on the CPU.

Each port artifact is a `torch.export` program traced with `--device
cpu`, saved, loaded back with `torch.export.load` and called with a state
dict converted from the JAX variables (`clip_state_dict_from_jax`,
`yolo_state_dict_from_jax`); the JAX artifact is called with those
variables.  The two agree within test_misc_tools.py's 2e-5 (relative and
absolute).  The port's program takes its weights as an input: the
artifact holds no parameter or buffer of the model (its only constants are
the detector config's anchor tables, which the JAX artifact bakes in
too), and a second set of weights gives the module's own output for
them.  Both
tools print the same JSON keys and input shape; `platforms` names the
device the port's program was traced and checked on.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu.cli.misc_tools import main as jmain
from cross_modal_video_engine_tpu.cli.yolo_train import (
    build_yolo_model as jbuild_yolo)
from cross_modal_video_engine_tpu.config import Config as JConfig
from cross_modal_video_engine_tpu.models.clip import CLIPModel as JCLIP
from cross_modal_video_engine_tpu.train.checkpoint import (
    save_checkpoint as jsave_checkpoint)
from cross_modal_video_engine_tpu_torch.cli import misc_tools as tmt
from cross_modal_video_engine_tpu_torch.convert import (
    clip_state_dict_from_jax, yolo_state_dict_from_jax)
from cross_modal_video_engine_tpu_torch.models import clip as tclip

TOL = 2e-5                 # rtol and atol, as test_misc_tools.py has it


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


def json_lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def both_lines(capsys, port_argv, jax_argv):
    tmt.main(port_argv)
    port = json_lines(capsys)[-1]
    jmain(jax_argv)
    want = json_lines(capsys)[-1]
    assert set(port) == set(want)
    assert port["in_shape"] == want["in_shape"]
    assert port["platforms"] == ["cpu"]
    return port


def assert_no_weights(path, anchors=()):
    """No parameter or buffer in the program; its only constants are the
    config's anchor tables (the JAX artifact bakes them in too)."""
    ep = torch.export.load(path)
    assert not ep.state_dict
    assert all(t.numel() == 0 for t in torch.utils._pytree.tree_leaves(
        ep.example_inputs))
    consts = sorted(c.tolist() for c in ep.constants.values())
    assert consts == sorted([list(map(list, a)) for a in anchors])


def test_export_model_matches_the_jax_artifact(tmp_path, capsys):
    cfg = tmt.clip_preset("tiny")
    jm = JCLIP(jax_clip_config())
    variables = jm.init(jax.random.key(3), jnp.zeros((1, 32, 32, 3)),
                        jnp.zeros((1, 8), jnp.int32))
    ckpt = str(tmp_path / "ckpt")
    jsave_checkpoint(ckpt, variables)
    port_out, jax_out = str(tmp_path / "m.pt2"), str(tmp_path / "m.hlo")
    common = ["--preset", "tiny", "--batch", "2", "--frames", "2",
              "--checkpoint", ckpt]
    line = both_lines(capsys,
                      ["export_model", "--output", port_out, "--device",
                       "cpu"] + common,
                      ["export_model", "--output", jax_out] + common)
    assert line["in_shape"] == [2, 2, 32, 32, 3]
    assert_no_weights(port_out)

    x = np.random.default_rng(21).standard_normal((2, 2, 32, 32, 3)).astype(
        np.float32)
    state = clip_state_dict_from_jax(jax.tree.map(np.asarray, variables),
                                     cfg)
    with torch.no_grad():
        got = torch.export.load(port_out).module()(state, torch.from_numpy(x))
    with open(jax_out, "rb") as f:
        exported = jax.export.deserialize(bytearray(f.read()))
    want = np.asarray(exported.call(variables, jnp.asarray(x)))
    assert got.shape == want.shape == (2, 2, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)

    # other weights: the program computes the module's output for them
    other = tclip.random_state_dict(cfg, seed=5)
    model = tclip.CLIPModel(cfg, device="cpu")
    model.load_state_dict(other)
    with torch.no_grad():
        got = torch.export.load(port_out).module()(other,
                                                   torch.from_numpy(x))
        want = model.encode_video(torch.from_numpy(x))[0]
    assert torch.equal(got, want)


def jax_clip_config():
    from cross_modal_video_engine_tpu.models.clip import CLIPConfig
    return CLIPConfig(embed_dim=16, image_resolution=32, vision_width=32,
                      vision_layers=2, vision_heads=2, patch_size=16,
                      context_length=8, vocab_size=64, text_width=16,
                      text_heads=2, text_layers=1)


@pytest.mark.parametrize("masks", [0, 4])
def test_export_yolo_matches_the_jax_artifact(tmp_path, capsys, masks):
    cfg_py = tmp_path / "yolo_cfg.py"
    seg = f", masks={masks}, protos=16" if masks else ""
    cfg_py.write_text("model = dict(num_classes=3, depth_multiple=0.33,"
                      f" width_multiple=0.125, img_size=64{seg})\n")
    port_out, jax_out = str(tmp_path / "y.pt2"), str(tmp_path / "y.hlo")
    line = both_lines(capsys,
                      ["export_yolo", str(cfg_py), "--output", port_out,
                       "--batch", "2", "--device", "cpu"],
                      ["export_yolo", str(cfg_py), "--output", jax_out,
                       "--batch", "2"])
    assert line["seg"] is bool(masks)
    jm = jbuild_yolo(JConfig.fromfile(str(cfg_py)))
    assert_no_weights(port_out, jm.cfg.anchors)

    x = np.random.default_rng(22).random((2, 64, 64, 3)).astype(np.float32)
    variables = jm.init(jax.random.key(0), jnp.asarray(x[:1]), train=False)
    state = yolo_state_dict_from_jax(jax.tree.map(np.asarray, variables),
                                     jm.cfg)
    with torch.no_grad():
        got = torch.export.load(port_out).module()(state, torch.from_numpy(x))
    with open(jax_out, "rb") as f:
        exported = jax.export.deserialize(bytearray(f.read()))
    want = exported.call(variables, jnp.asarray(x))
    got = got if masks else (got,)
    want = want if masks else (want,)
    assert len(got) == len(want) == (2 if masks else 1)
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.asarray(w).shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)
