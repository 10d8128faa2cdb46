"""The port's detector training CLIs (cli/yolo_train.py's trainer,
cli/yolo_cls_train.py) against the JAX package's, on the CPU: two epochs of
two steps each on tiny seeded splits (`.npy` images of 48-80 px, label
files of boxes or polygons, an ImageFolder of 3 classes), width 0.125 at
64 px, f32, the shipped augmentations (mosaic, HSV, flips), AutoAnchor on.
Both CLIs start from one JAX-format checkpoint (`load_from`), so their
histories compare.

Tolerances: the per-epoch losses within 1e-4 relative; mAP, mask mAP and
top-1/top-5 within 1e-6 (the EMA weights differ from JAX's by f32 noise,
see tests/test_torch_yolo_train.py); the `best/` payload's tensors within
1e-3 of each tensor's largest magnitude (four steps at the warmup's bias
lr move the small BatchNorm biases by their gradients' f32 noise: up to
3.3e-4 seen) and its loop state (epoch, anchors) equal.  Also: the anchors AutoAnchor writes equal JAX's, a
resumed epoch 1 equals the uninterrupted one (the port restores the
augmentation RandomState), `main` runs, and `shapes_and_labels` reads
`.npy` shapes from an mmap and other files through the reader."""

import json
import os

import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu.cli import yolo_cls_train as jct
from cross_modal_video_engine_tpu.cli import yolo_train as jyt
from cross_modal_video_engine_tpu.config import Config as JConfig
from cross_modal_video_engine_tpu_torch.cli import yolo_cls_train as tct
from cross_modal_video_engine_tpu_torch.cli import yolo_train as tyt
from cross_modal_video_engine_tpu_torch.config import Config
from cross_modal_video_engine_tpu_torch.convert import (
    yolo_cls_variables_to_jax, yolo_variables_to_jax)
from cross_modal_video_engine_tpu_torch.models import yolo as tyolo
from cross_modal_video_engine_tpu_torch.train import resume as tresume
from cross_modal_video_engine_tpu_torch.train.checkpoint import (
    save_checkpoint)

SIZE = 64
LOSS_REL, MAP_TOL, STATE_REL = 1e-4, 1e-6, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


def _polygon(rng):
    c = rng.uniform(0.25, 0.75, 2)
    r = rng.uniform(0.1, 0.25)
    a = np.sort(rng.uniform(0, 2 * np.pi, int(rng.integers(4, 8))))
    return (c + r * np.stack([np.cos(a), np.sin(a)], 1)).clip(0.01, 0.99)


def write_split(root, n, seed, seg):
    """n `.npy` images of 48-80 px and their label files (boxes, or
    polygons for the segment head)."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "labels"))
    for i in range(n):
        h, w = (int(v) for v in rng.integers(48, 81, 2))
        np.save(os.path.join(root, "images", f"im{i}.npy"),
                rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        rows = []
        for _ in range(int(rng.integers(1, 4))):
            cls = int(rng.integers(0, 3))
            if seg:
                p = _polygon(rng)
                rows.append(" ".join([str(cls)] + [f"{v:.6f}"
                                                   for v in p.ravel()]))
            else:
                cxy = rng.uniform(0.3, 0.7, 2)
                wh = rng.uniform(0.1, 0.5, 2)
                rows.append(" ".join([str(cls)] + [f"{v:.6f}" for v in
                                                   (*cxy, *wh)]))
        with open(os.path.join(root, "labels", f"im{i}.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")
    return os.path.join(root, "images"), os.path.join(root, "labels")


def write_detect_config(root, seg, start):
    tr_img, tr_lab = write_split(os.path.join(root, "train"), 4, 1, seg)
    va_img, va_lab = write_split(os.path.join(root, "val"), 3, 2, seg)
    model = dict(num_classes=3, depth_multiple=0.33, width_multiple=0.125,
                 img_size=SIZE)
    if seg:
        model.update(masks=4, protos=16)
    text = f"""
model = {model!r}
data = dict(train=dict(img_dir={tr_img!r}, label_dir={tr_lab!r}),
            val=dict(img_dir={va_img!r}, label_dir={va_lab!r}),
            batch_size=2, max_targets=8, mask_ratio=4)
aug = dict(hsv_h=0.015, hsv_s=0.7, hsv_v=0.4, translate=0.1, scale=0.5,
           fliplr=0.5, mosaic=1.0)
optimizer = dict(lr0=0.01, warmup_epochs=3.0)
load_from = {start!r}
autoanchor_gen = 50
loss_mask_cap = 16
bf16 = False
total_epochs = 2
"""
    path = os.path.join(root, "cfg.py")
    with open(path, "w") as f:
        f.write(text)
    return path


def _start(root, cfg, classifier=False, seed=3):
    sd = tyolo.random_state_dict(cfg, seed=seed, classifier=classifier)
    to_jax = yolo_cls_variables_to_jax if classifier \
        else yolo_variables_to_jax
    path = os.path.join(root, "start")
    save_checkpoint(path, to_jax(sd, cfg))
    return path


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _history_close(got, want):
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert g["epoch"] == w["epoch"]
        assert _rel(g["loss"], w["loss"]) <= LOSS_REL
        for k in set(w) - {"epoch", "loss", "lr"}:
            assert abs(g[k] - w[k]) <= MAP_TOL, k


def _read_best(work_dir):
    best = os.path.join(work_dir, "best")
    with open(os.path.join(best, tresume.STATE_FILE), "rb") as f:
        tree = tresume.flax_msgpack.restore(f.read())
    with open(os.path.join(best, tresume.LOOP_FILE)) as f:
        return tree, json.load(f)


def _leaves(t, pre=""):
    if isinstance(t, dict):
        for k in sorted(t):
            yield from _leaves(t[k], f"{pre}/{k}")
    else:
        yield pre, t


def _best_close(port_dir, jax_dir, keys):
    (a, la), (b, lb) = _read_best(port_dir), _read_best(jax_dir)
    for k in keys:
        assert la[k] == lb[k], k
    got, want = dict(_leaves(a)), dict(_leaves(b))
    assert got.keys() == want.keys()
    for k in got:
        assert _rel(got[k], want[k]) <= STATE_REL, k


@pytest.fixture(scope="module", params=["detect", "segment"])
def detect_runs(request, tmp_path_factory):
    seg = request.param == "segment"
    root = str(tmp_path_factory.mktemp(request.param))
    mcfg = tyolo.YoloConfig(num_classes=3, depth_multiple=0.33,
                            width_multiple=0.125, img_size=SIZE,
                            masks=4 if seg else 0, protos=16 if seg else 0)
    path = write_detect_config(root, seg, _start(root, mcfg))
    jw, tw = os.path.join(root, "jax"), os.path.join(root, "port")
    _, jhist = jyt.train_from_config(JConfig.fromfile(path), jw)
    state, thist = tyt.train_from_config(Config.fromfile(path), tw,
                                         device="cpu")
    return seg, path, root, jw, tw, jhist, thist, state


def test_detect_cli_matches_jax(detect_runs):
    seg, path, root, jw, tw, jhist, thist, _ = detect_runs
    _history_close(thist, jhist)
    _best_close(tw, jw, ("epoch", "anchors"))
    for e in (0, 1):
        la = json.load(open(os.path.join(tw, f"epoch_{e}",
                                         tresume.LOOP_FILE)))
        lb = json.load(open(os.path.join(jw, f"epoch_{e}",
                                         tresume.LOOP_FILE)))
        assert la["anchors"] == lb["anchors"] and la["epoch"] == lb["epoch"]


def test_best_is_read_by_yolo_val_and_ctv_build(detect_runs):
    """best/ holds the EMA weights of the best epoch: yolo_val's row on the
    val split is that epoch's mAP, and ctv_build's loader reads the same
    detector."""
    from cross_modal_video_engine_tpu_torch.cli import ctv_build, yolo_val
    seg, path, root, jw, tw, jhist, thist, _ = detect_runs
    best = os.path.join(tw, "best")
    with open(os.path.join(best, tresume.LOOP_FILE)) as f:
        epoch = json.load(f)["epoch"]
    report = yolo_val.main([path, "--checkpoint", best, "--device", "cpu"])
    got = report["boxes"] if seg else report
    assert got["map"] == thist[epoch]["map"]
    a = yolo_val.load_detector(Config.fromfile(path), best, "cpu")
    b = ctv_build.load_detector_checkpoint(best, "cpu")
    assert a.cfg == b.cfg
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k


def test_resumed_epoch_equals_uninterrupted(detect_runs):
    seg, path, root, jw, tw, jhist, thist, state = detect_runs
    rw = os.path.join(root, "resumed")
    os.makedirs(rw)
    import shutil
    shutil.copytree(os.path.join(tw, "epoch_0"), os.path.join(rw, "epoch_0"))
    resumed, rhist = tyt.main([path, "--work_dir", rw, "--resume",
                               "--device", "cpu"])
    assert [r["epoch"] for r in rhist] == [1]
    assert rhist[0] == thist[1]
    for a, b in ((resumed.model, state.model), (resumed.ema, state.ema)):
        for (k, x), y in zip(a.state_dict().items(),
                             b.state_dict().values()):
            assert torch.equal(x, y), k


def write_imagefolder(root, n_per, seed):
    rng = np.random.default_rng(seed)
    for c in ("cat", "dog", "emu"):
        os.makedirs(os.path.join(root, c))
        for i in range(n_per):
            h, w = (int(v) for v in rng.integers(40, 90, 2))
            np.save(os.path.join(root, c, f"{i}.npy"),
                    rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


@pytest.fixture(scope="module")
def cls_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cls"))
    write_imagefolder(os.path.join(root, "train"), 2, 3)
    write_imagefolder(os.path.join(root, "val"), 1, 4)
    mcfg = tyolo.YoloConfig(num_classes=3, depth_multiple=0.33,
                            width_multiple=0.125, img_size=SIZE)
    start = _start(root, mcfg, classifier=True)
    text = f"""
model = dict(num_classes=3, depth_multiple=0.33, width_multiple=0.125,
             img_size={SIZE})
data = dict(train_dir={os.path.join(root, 'train')!r},
            val_dir={os.path.join(root, 'val')!r}, batch_size=3)
aug = dict(fliplr=0.5)
optimizer = dict(lr0=0.001)
lrf = 0.01
weight_decay = 5e-5
label_smoothing = 0.1
load_from = {start!r}
bf16 = False
total_epochs = 2
"""
    path = os.path.join(root, "cfg.py")
    with open(path, "w") as f:
        f.write(text)
    jw, tw = os.path.join(root, "jax"), os.path.join(root, "port")
    _, jhist = jct.train_from_config(JConfig.fromfile(path), jw)
    state, thist = tct.train_from_config(Config.fromfile(path), tw,
                                         device="cpu")
    return path, root, jw, tw, jhist, thist, state


def test_cls_cli_matches_jax(cls_runs):
    path, root, jw, tw, jhist, thist, _ = cls_runs
    _history_close(thist, jhist)
    for g, w in zip(thist, jhist):
        assert g["lr"] == w["lr"]
    if os.path.isdir(os.path.join(jw, "best")):
        _best_close(tw, jw, ("epoch", "classes"))


def test_cls_cli_resume(cls_runs):
    path, root, jw, tw, jhist, thist, state = cls_runs
    rw = os.path.join(root, "resumed")
    import shutil
    shutil.copytree(os.path.join(tw, "epoch_0"), os.path.join(rw, "epoch_0"))
    resumed, rhist = tct.main([path, "--work_dir", rw, "--resume",
                               "--device", "cpu"])
    assert rhist == thist[1:]
    for (k, x), y in zip(resumed.ema.state_dict().items(),
                         state.ema.state_dict().values()):
        assert torch.equal(x, y), k


def test_shapes_and_labels(tmp_path):
    img_dir, lab_dir = write_split(str(tmp_path / "s"), 3, 9, seg=False)
    ds = tyt.YoloDetectionDataset(img_dir, lab_dir)
    shapes, labels = ds.shapes_and_labels()
    jshapes, jlabels = jyt.YoloDetectionDataset(img_dir,
                                                lab_dir).shapes_and_labels()
    np.testing.assert_array_equal(shapes, jshapes)
    for a, b in zip(labels, jlabels):
        np.testing.assert_array_equal(a, b)
    (tmp_path / "s" / "images" / "x.jpg").write_bytes(b"not read")
    seen = []
    frame = np.zeros((30, 50, 3), np.uint8)
    ds = tyt.YoloDetectionDataset(img_dir, lab_dir,
                                  reader=lambda p: seen.append(p) or frame)
    shapes, _ = ds.shapes_and_labels()
    assert seen == [str(tmp_path / "s" / "images" / "x.jpg")]
    assert shapes[-1].tolist() == [30.0, 50.0]
