"""The port's detector validation (cli/yolo_train.py's val half,
cli/yolo_val.py, train/resume.py's detector payload) against the JAX
package's CLI on the CPU, on a tiny yolov5-layout directory: seeded
`.npy` images of 48x64 and 64x48, labels that are the port's own
detections at conf 0.25 (mapped back through the letterbox), a detector
of width 0.125 at 64² from one seeded ultralytics-layout state dict whose
two firing classes fire on every image.

Tolerances: the CLIs' JSON rows equal within 1e-6 (mAP@0.5, mAP,
precision, recall, per-class AP), for a `best/` directory the JAX package wrote and for a
`save_checkpoint` directory, with `--augment` and for the segment head;
the TTA predictions within 1e-5 relative of JAX's; the `best/` bytes the
port writes equal to JAX's."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu.cli import yolo_train as jyt
from cross_modal_video_engine_tpu.cli import yolo_val as jyv
from cross_modal_video_engine_tpu.convert import convert_yolov5
from cross_modal_video_engine_tpu.models import yolo as jyolo
from cross_modal_video_engine_tpu.train import resume as jresume
from cross_modal_video_engine_tpu.train.checkpoint import (
    save_checkpoint as jax_save_checkpoint)
from cross_modal_video_engine_tpu_torch.cli import yolo_train as tyt
from cross_modal_video_engine_tpu_torch.cli import yolo_val as tyv
from cross_modal_video_engine_tpu_torch.models import yolo as tyolo
from cross_modal_video_engine_tpu_torch.train import resume as tresume
from cross_modal_video_engine_tpu_torch.train.yolo_trainer import letterbox

SIZE = 64
CFG = tyolo.YoloConfig(num_classes=6, depth_multiple=0.33,
                       width_multiple=0.125, img_size=SIZE)
SEG = dataclasses.replace(CFG, masks=4, protos=16)
FIRE = (1, 4)
# a second geometry, as AutoAnchor writes it into loop_state.json
ANCHORS = tuple(tuple((w * 1.25, h * 0.8) for w, h in layer)
                for layer in tyolo.DEFAULT_ANCHORS)


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


def detector(cfg, seed=3):
    """(seeded state dict, the port's detector loaded with it)."""
    sd = tyolo.random_state_dict(cfg, seed=seed, fire=FIRE)
    model = tyolo.YoloV5(cfg, device="cpu")
    model.load_state_dict(sd)
    return sd, model


def own_labels(model, img):
    """The model's detections at conf 0.25 in the val protocol (multi
    label, NMS at 0.6) on the letterboxed image, as normalized `cls cx cy
    w h` rows of the original image."""
    h, w = img.shape[:2]
    lb, r, (px, py) = letterbox(img, SIZE)
    with torch.no_grad():
        out = model(torch.from_numpy(lb[None]).float() / 255.0)
    maps = out[0] if model.cfg.masks else out
    det = tyolo.postprocess(
        tyolo.decode_predictions(maps, model.cfg)[..., :5 + model.cfg
                                                  .num_classes].numpy(),
        iou_thres=0.6, multi_label=True)[0]
    x1, x2 = ((det[:, [0, 2]] - px) / r).T
    y1, y2 = ((det[:, [1, 3]] - py) / r).T
    return np.stack([det[:, 5], (x1 + x2) / 2 / w, (y1 + y2) / 2 / h,
                     (x2 - x1) / w, (y2 - y1) / h], 1)


def write_val_dir(root, model, n=6, seg=False, seed=7):
    """n seeded .npy images (48x64 and 64x48) with the model's own
    detections as labels (as box polygons for the segment head)."""
    rng = np.random.default_rng(seed)
    img_dir, label_dir = os.path.join(root, "images"), os.path.join(
        root, "labels")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(label_dir, exist_ok=True)
    for i in range(n):
        hw = (48, 64) if i % 2 == 0 else (64, 48)
        img = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
        np.save(os.path.join(img_dir, f"im{i}.npy"), img)
        rows = own_labels(model, img)
        with open(os.path.join(label_dir, f"im{i}.txt"), "w") as f:
            for c, cx, cy, w, h in rows:
                if seg:
                    x1, y1, x2, y2 = cx - w / 2, cy - h / 2, cx + w / 2, \
                        cy + h / 2
                    pts = [x1, y1, x2, y1, x2, y2, x1, y2]
                    f.write(" ".join([str(int(c))] + [f"{v:.6f}"
                                                      for v in pts]) + "\n")
                else:
                    f.write(f"{int(c)} {cx:.6f} {cy:.6f} {w:.6f} {h:.6f}\n")
    return img_dir, label_dir


def write_config(path, cfg, img_dir, label_dir):
    model = dict(num_classes=cfg.num_classes,
                 depth_multiple=cfg.depth_multiple,
                 width_multiple=cfg.width_multiple, img_size=cfg.img_size,
                 masks=cfg.masks, protos=cfg.protos)
    with open(path, "w") as f:
        f.write(f"model = {model!r}\n"
                f"data = dict(val=dict(img_dir={img_dir!r}, "
                f"label_dir={label_dir!r}), batch_size=4, max_targets=32, "
                f"mask_ratio=4)\n")
    return path


def jax_best(path, sd, cfg, anchors=None):
    """A `best/` directory as the JAX yolo_train writes it."""
    variables = convert_yolov5(sd, cfg)
    loop = {"epoch": 3, "fitness": 0.5}
    if anchors is not None:
        loop["anchors"] = [list(map(list, layer)) for layer in anchors]
    jresume.save_train_state(path, {"params": variables["params"],
                                    "batch_stats": variables["batch_stats"]},
                             loop)
    return path


@pytest.fixture(scope="module", params=["detect", "segment"])
def world(request, tmp_path_factory):
    cfg = SEG if request.param == "segment" else CFG
    root = str(tmp_path_factory.mktemp(request.param))
    sd, model = detector(cfg)
    img_dir, label_dir = write_val_dir(root, model, seg=bool(cfg.masks))
    config = write_config(os.path.join(root, "cfg.py"), cfg, img_dir,
                          label_dir)
    best = jax_best(os.path.join(root, "best"), sd, cfg)
    ckpt = os.path.join(root, "ckpt")
    jax_save_checkpoint(ckpt, convert_yolov5(sd, cfg),
                        jyolo.YoloConfig(**dataclasses.asdict(cfg)))
    return cfg, sd, config, best, ckpt


def _rows(main, argv, capsys):
    main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _same_row(got, want):
    """The same keys, AP values and counts; the precision and recall read
    off interpolated curves within 1e-6 (the scores differ in f32's last
    bits between the packages)."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, dict):
            _same_row(got[k], w)
        else:
            assert got[k] == pytest.approx(w, rel=0, abs=1e-6), k


@pytest.mark.parametrize("which", ["best", "ckpt"])
def test_yolo_val_cli_matches_jax(world, which, capsys):
    cfg, _, config, best, ckpt = world
    argv = [config, "--checkpoint", best if which == "best" else ckpt]
    want = _rows(jyv.main, argv, capsys)
    got = _rows(tyv.main, argv + ["--device", "cpu"], capsys)
    _same_row(got, want)
    key = got["boxes"] if cfg.masks else got
    assert key["map50"] >= 0.99          # the labels are its own detections


def test_yolo_val_augment_matches_jax(world, capsys):
    cfg, _, config, best, _ = world
    argv = [config, "--checkpoint", best, "--augment"]
    if cfg.masks:
        with pytest.raises(SystemExit):
            jyv.main(argv)
        with pytest.raises(SystemExit):
            tyv.main(argv + ["--device", "cpu"])
        return
    _same_row(_rows(tyv.main, argv + ["--device", "cpu"], capsys),
              _rows(jyv.main, argv, capsys))


def test_tta_predictions_match_jax():
    sd, model = detector(CFG)
    x = np.random.default_rng(2).random((2, SIZE, SIZE, 3), np.float32)
    variables = convert_yolov5(sd, CFG)
    jm = jyolo.YoloV5(jyolo.YoloConfig(**dataclasses.asdict(CFG)))
    want = np.asarray(jyt._det_infer_tta(jm)(
        variables["params"], variables["batch_stats"], jnp.asarray(x)))
    got = tyt._det_infer_tta(model)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_best_directory_bytes_and_anchors(world, tmp_path):
    """The port writes the `best/` payload byte for byte as JAX does, and
    `load_train_state` applies the loop state's anchors."""
    cfg, sd, _, _, _ = world
    _, model = detector(cfg)
    loop = {"anchors": [list(map(list, layer)) for layer in ANCHORS]}
    tresume.save_train_state(str(tmp_path / "port"), {"detector": model},
                             loop)
    jax_best(str(tmp_path / "jax"), sd, cfg, ANCHORS)
    for name in ("train_state.msgpack", "loop_state.json"):
        with open(tmp_path / "port" / name, "rb") as a, \
                open(tmp_path / "jax" / name, "rb") as b:
            if name.endswith(".msgpack"):
                assert a.read() == b.read()
    fresh = tyolo.YoloV5(cfg, device="cpu")
    _, got_loop = tresume.load_train_state(str(tmp_path / "jax"),
                                           {"detector": fresh})
    assert got_loop["anchors"] == loop["anchors"]
    assert fresh.cfg.anchors == ANCHORS
    torch.testing.assert_close(
        fresh.model[24].anchors,
        torch.tensor(ANCHORS) / torch.tensor([8.0, 16, 32]).view(3, 1, 1))
    for k, v in sd.items():
        if "anchors" not in k:
            torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0,
                                       atol=0)


def test_yolo_val_reads_the_anchors_of_best(world, tmp_path, capsys):
    """A `best/` whose loop state carries evolved anchors: both CLIs
    decode with them."""
    cfg, sd, config, _, _ = world
    best = jax_best(str(tmp_path / "best"), sd, cfg, ANCHORS)
    argv = [config, "--checkpoint", best]
    _same_row(_rows(tyv.main, argv + ["--device", "cpu"], capsys),
              _rows(jyv.main, argv, capsys))


def test_reader_seam_and_refusals(tmp_path):
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    (img_dir / "a.jpg").write_bytes(b"not read")
    frame = np.full((40, 30, 3), 7, np.uint8)
    seen = []
    ds = tyt.YoloDetectionDataset(str(img_dir), str(tmp_path),
                                  reader=lambda p: seen.append(p) or frame)
    img, labels = ds[0]
    assert seen == [str(img_dir / "a.jpg")] and img.shape == (40, 30, 3)
    assert labels.shape == (0, 5)
    # the training half is ported: the aug arm runs through the reader
    # (a mosaic of four draws of the one image), and shapes_and_labels
    # reads the shape through it
    from cross_modal_video_engine_tpu_torch.data.yolo_aug import YoloAugHyp
    images, *_ = next(tyt.yolo_batches(ds, 2, SIZE, 4, aug=YoloAugHyp(),
                                       rng=np.random.RandomState(0)))
    assert images.shape == (2, SIZE, SIZE, 3) and len(seen) == 9
    shapes, labels = ds.shapes_and_labels()
    assert shapes.tolist() == [[40.0, 30.0]] and len(seen) == 10
    with pytest.raises(SystemExit):
        tyt.main([])
