"""cli/dump_features.py against the JAX CLI (cross_modal_video_engine_tpu/
cli/dump_features.py) on a tiny joint TimeSformer with flash attention
(8 x 32², patch 8, width 64, 4 heads, 3 layers, 5 classes, f32): the
same checkpoint, config and videos give the same pickle in each mode
(`pred` equal; each embedding and gradient vector within TOL of its
largest element, relative).  The checkpoint is written by the JAX
package, or by the port through convert/from_jax.py; the JAX flash
kernel runs in interpret mode, the port's flash attention on CPU tensors
its plain version.  The `reader=` seam is checked on raw AVIs decoded by
the native decoder against the same frames handed in from memory.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu.cli import dump_features as jdump
from cross_modal_video_engine_tpu.models import recognizer as jrec
from cross_modal_video_engine_tpu.models import timesformer as jts
from cross_modal_video_engine_tpu.train.checkpoint import (
    save_checkpoint as jax_save_checkpoint)
from cross_modal_video_engine_tpu_torch import api
from cross_modal_video_engine_tpu_torch.bench.extra import write_raw_avi
from cross_modal_video_engine_tpu_torch.cli import dump_features as tdump
from cross_modal_video_engine_tpu_torch.convert import (
    recognizer_variables_to_jax)
from cross_modal_video_engine_tpu_torch.data.datasets import VideoDataset
from cross_modal_video_engine_tpu_torch.data.pipelines import build_pipeline
from cross_modal_video_engine_tpu_torch.io import _native_build
from cross_modal_video_engine_tpu_torch.io.native import NativeVideoReader
from cross_modal_video_engine_tpu_torch.models import recognizer as trec
from cross_modal_video_engine_tpu_torch.models.timesformer import (
    TimeSformerConfig)
from cross_modal_video_engine_tpu_torch.train.checkpoint import (
    save_checkpoint)
from test_torch_caption_api import PIPE, TS, write_videos
from torch_parity import interpret_pallas, random_variables

BACKBONE = dict(TS, num_layers=3)
CLASSES, TOL = 5, 1e-4
LAYERS = ["0", "2"]


@pytest.fixture(autouse=True, scope="module")
def _interpret():
    with pytest.MonkeyPatch.context() as mp:
        interpret_pallas(mp)
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


def write_config(root, videos, pipeline=PIPE) -> str:
    ann = os.path.join(root, "ann.txt")
    with open(ann, "w") as f:
        f.write("\n".join(f"{os.path.basename(v)} {i % CLASSES}"
                          for i, v in enumerate(videos)))
    cfg = os.path.join(root, "dump.py")
    with open(cfg, "w") as f:
        f.write(f"data = dict(videos_per_gpu=2, pipeline={pipeline!r},\n"
                f"            val=dict(ann_file={ann!r}, "
                f"data_prefix={os.path.dirname(videos[0])!r}))\n")
    return cfg


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Three videos (two batches: 2 + 1), their config, a checkpoint the
    JAX package wrote and one the port wrote, both of seeded weights."""
    root = str(tmp_path_factory.mktemp("dump"))
    videos = write_videos(root, 3, seed=9)
    jm = jrec.Recognizer3D(jts.TimeSformerConfig(**BACKBONE),
                           num_classes=CLASSES)
    variables = random_variables(jm.init(
        jax.random.key(0), jnp.zeros((1, 8, 32, 32, 3), jnp.float32)), 23)
    jax_ckpt = os.path.join(root, "jax_ckpt")
    jax_save_checkpoint(jax_ckpt, variables, {"backbone": dict(BACKBONE),
                                              "num_classes": CLASSES})
    cfg = TimeSformerConfig(**BACKBONE)
    port_ckpt = os.path.join(root, "port_ckpt")
    save_checkpoint(port_ckpt, recognizer_variables_to_jax(
        trec.random_state_dict(cfg, 24, num_classes=CLASSES), cfg),
        {"backbone": dict(BACKBONE), "num_classes": CLASSES})
    return dict(root=root, videos=videos, cfg=write_config(root, videos),
                ckpt={"jax": jax_ckpt, "port": port_ckpt})


def _same_dump(got: dict, want: dict, mode: str):
    assert list(got) == list(want)
    keys = {"embeddings": ["pred", 0, 2], "grads": ["pred", ("grad", 0),
                                                    ("grad", 2)],
            "both": ["pred", 0, 2, ("grad", 0), ("grad", 2)]}[mode]
    for name in want:
        assert list(got[name]) == keys == list(want[name])
        assert got[name]["pred"] == want[name]["pred"]
        for k in keys[1:]:
            g, w = got[name][k], np.asarray(want[name][k])
            assert g.dtype == np.float32 and g.shape == (64,) == w.shape
            scale = float(np.abs(w).max())
            assert scale > 0
            assert float(np.abs(g - w).max()) <= TOL * scale, (name, k)


def _run_both(world, tmp_path, capsys, ckpt, extra):
    argv = [world["cfg"], "--checkpoint", world["ckpt"][ckpt], "--layers",
            *LAYERS, *extra]
    want = jdump.main(argv + ["--out", str(tmp_path / "jax.pkl")])
    got = tdump.main(argv + ["--out", str(tmp_path / "port.pkl"),
                             "--device", "cpu"])
    with open(tmp_path / "port.pkl", "rb") as f:
        assert pickle.load(f).keys() == got.keys()
    capsys.readouterr()
    return got, want


@pytest.mark.parametrize("mode", ["embeddings", "grads", "both"])
def test_dump_matches_jax(world, tmp_path, capsys, mode):
    got, want = _run_both(world, tmp_path, capsys, "jax", ["--mode", mode])
    assert sorted(got) == sorted(world["videos"])
    _same_dump(got, want, mode)


def test_dump_of_a_port_checkpoint_with_a_target_class(world, tmp_path,
                                                       capsys):
    """The port's weights through recognizer_variables_to_jax, read by
    both CLIs; the gradients of a named class."""
    got, want = _run_both(world, tmp_path, capsys, "port",
                          ["--mode", "both", "--target_class", "3"])
    _same_dump(got, want, "both")


def test_dump_features_function_with_a_state(world):
    """dump_features(model, state, ...): `state` loaded into the model
    first gives what the model holding those weights gives."""
    model, _ = api.init_recognizer(world["ckpt"]["jax"], device="cpu")
    other, _ = api.init_recognizer(world["ckpt"]["port"], device="cpu")
    ds = VideoDataset(os.path.join(world["root"], "ann.txt"),
                      build_pipeline(PIPE), os.path.dirname(
                          world["videos"][0]))
    want = tdump.dump_features(model, None, ds, (1,), 2, "both")
    got = tdump.dump_features(other, model.state_dict(), ds, (1,), 2, "both")
    for name in want:
        for k in want[name]:
            np.testing.assert_array_equal(got[name][k], want[name][k])


class FramesReader:
    """A decord-alike over frames in memory."""

    def __init__(self, frames):
        self.frames, self.fps = frames, 30.0

    def __len__(self):
        return len(self.frames)

    def get_batch(self, indices):
        return self.frames[np.asarray(indices)]

    def release(self):
        pass


@pytest.mark.skipif(not _native_build.libav_probe().found,
                    reason=_native_build.libav_probe().reason or "libav")
def test_reader_seam_with_the_native_decoder(world, tmp_path, capsys):
    """Raw AVIs decoded by NativeVideoReader through `reader=` give the
    pickle the same frames handed in from memory give."""
    rng = np.random.default_rng(25)
    frames, videos = {}, []
    for i in range(3):
        videos.append(str(tmp_path / f"r{i}.avi"))
        frames[videos[-1]] = rng.integers(0, 256, (30, 40, 54, 3),
                                          dtype=np.uint8)
        write_raw_avi(videos[-1], frames[videos[-1]])
    cfg = write_config(str(tmp_path), videos)
    argv = [cfg, "--checkpoint", world["ckpt"]["jax"], "--layers", "1",
            "--mode", "both", "--out", str(tmp_path / "f.pkl")]
    got = tdump.main(argv, device="cpu", reader=NativeVideoReader)
    want = tdump.main(argv, device="cpu",
                      reader=lambda p: FramesReader(frames[p]))
    capsys.readouterr()
    assert sorted(got) == sorted(videos)
    for name in want:
        for k in want[name]:
            np.testing.assert_array_equal(got[name][k], want[name][k])
