"""Misc / deployment tools (MCT/tools/misc + tools/deployment equivalents).

Counterpart of cross_modal_video_engine_tpu/cli/misc_tools.py; each
subcommand writes the bytes the JAX tool writes from the same inputs.

  flow_extraction: video -> quantized optical-flow rawframes
      (misc/flow_extraction.py:10-123; Farneback, the reference's own
      fallback `method='farneback'`, with the clip-to-[-bound,bound]
      uint8 quantization and flow_x/flow_y naming); the frames decode
      through io/native.NativeVideoReader and the flow is cv2's, so the
      tool needs cv2 and refuses with ImportError where it is missing
  bsn_pgm: TEM result curves -> PGM proposals csv + BSP feature npy per
      video, the exact LoadProposals input contract
      (misc/bsn_proposal_generation.py:32-157)
  publish_model: stamp a checkpoint file with its sha256 prefix
      (deployment/publish_model.py)

  export_model: CLIPModel.encode_video's first output (the ViT CLS
      feature per frame) as a `torch.export` program, for the 'tiny' and
      'vitb32' (the bf16 flagship) presets, `--checkpoint` a directory in
      the JAX package's format
  export_yolo: a YOLOv5 config's forward and `decode_predictions` (and
      the prototype maps where masks > 0) as a `torch.export` program;
      NMS stays on the host, as in the reference's exported graphs

Both programs take (state dict, input): the weights are an input, as the
JAX tools' StableHLO artifacts take their variables as an argument, so
the `.pt2` file holds the program and not the weights.  Each is traced
on `--device` (the card by default: a traced `arange` or `zeros` keeps
its device), saved, loaded back, called with the model's own state on
seeded inputs and held to the module's output before the tool prints
the JAX tool's JSON line; its `platforms` names that device.  The
exported forward is the plain one (the kernels' ctypes launches do not
trace), as the JAX export's is: the JAX presets leave `fused_attn` and
`fused_mlp` off.

Usage: python -m cross_modal_video_engine_tpu_torch.cli.misc_tools CMD ...
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np
import torch

# an exported program's outputs against the module's own: relative to
# the largest output (bf16 programs compute what the module computes, in
# the same kernels, so both hold far tighter in practice)
EXPORT_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


class _Bound(torch.nn.Module):
    """forward(x) = call(m, x)."""

    def __init__(self, module: torch.nn.Module, call):
        super().__init__()
        self.m = module
        self._call = call

    def forward(self, x):
        return self._call(self.m, x)


class _StateProgram(torch.nn.Module):
    """forward(state, x): `call(module, x)` with the module's weights and
    buffers taken from `state` (torch.func.functional_call); the module
    is held outside the module tree, so the exported program lifts no
    weight of its own."""

    def __init__(self, module: torch.nn.Module, call):
        super().__init__()
        object.__setattr__(self, "_bound", _Bound(module, call))

    def forward(self, state, x):
        return torch.func.functional_call(
            self._bound, {f"m.{k}": v for k, v in state.items()}, (x,))


def export_program(model: torch.nn.Module, call, x: torch.Tensor,
                   output: str, tol: float) -> dict:
    """Exports call(model, x) with the state as an input, saves it to
    `output`, loads it back and holds its outputs on x to the module's
    (max |diff| over the largest |output| <= tol, else RuntimeError).
    Returns {"bytes", "seconds" (export and save), "max_abs_err"}."""
    import time
    model.eval().requires_grad_(False)
    state = dict(model.state_dict())
    t0 = time.perf_counter()
    with torch.no_grad():
        ep = torch.export.export(_StateProgram(model, call), (state, x),
                                 strict=False)
    # the program keeps its example inputs, the weights among them; empty
    # tensors in their place keep the structure, by which the loaded
    # program matches a state dict's keys in any order
    ep.example_inputs = torch.utils._pytree.tree_map_only(
        torch.Tensor, lambda t: torch.empty(0, dtype=t.dtype),
        ep.example_inputs)
    torch.export.save(ep, output)
    seconds = time.perf_counter() - t0
    loaded = torch.export.load(output).module()
    with torch.no_grad():
        got = torch.utils._pytree.tree_leaves(loaded(state, x))
        want = torch.utils._pytree.tree_leaves(call(model, x))
    err = 0.0
    for g, w in zip(got, want):
        scale = float(w.float().abs().max()) or 1.0
        e = float((g.float() - w.float()).abs().max())
        if not e <= tol * scale:
            raise RuntimeError(f"the exported program's output differs from "
                               f"the module's by {e} (largest {scale})")
        err = max(err, e)
    return {"bytes": os.path.getsize(output), "seconds": seconds,
            "max_abs_err": err}


def clip_preset(preset: str):
    """export_model's CLIP config: 'tiny', or 'vitb32' (the bf16
    flagship, fused_attn and fused_mlp off as the JAX preset has them)."""
    from ..models.clip import CLIPConfig
    if preset == "tiny":
        return CLIPConfig(embed_dim=16, image_resolution=32, vision_width=32,
                          vision_layers=2, vision_heads=2, patch_size=16,
                          context_length=8, vocab_size=64, text_width=16,
                          text_heads=2, text_layers=1)
    return CLIPConfig(dtype="bfloat16")


def export_model(args):
    from ..convert.from_jax import clip_state_dict_from_jax
    from ..models.clip import CLIPModel, random_state_dict
    from ..train.checkpoint import load_checkpoint
    from ..utils.device import resolve_device
    dev = resolve_device(args.device)
    cfg = clip_preset(args.preset)
    model = CLIPModel(cfg, device=dev)
    if args.checkpoint:
        variables, _cfg, _meta = load_checkpoint(args.checkpoint)
        model.load_state_dict(clip_state_dict_from_jax(variables, cfg))
    else:
        model.load_state_dict(random_state_dict(cfg, seed=0))
    B, F, R = args.batch, args.frames, cfg.image_resolution
    frames = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (B, F, R, R, 3)).astype(np.float32)).to(dev)
    out = export_program(model, lambda m, x: m.encode_video(x)[0], frames,
                         args.output, EXPORT_TOL[cfg.dtype])
    print(json.dumps({"output": args.output, "bytes": out["bytes"],
                      "in_shape": list(frames.shape),
                      "platforms": [dev.type]}))


def export_yolo(args):
    """The YOLOv5 detector's forward and decode (the prototype maps too
    where masks > 0) as a torch.export program: (state dict, (B, S, S, 3)
    float images in [0, 1]) -> decoded (B, N, 5 + nc [+ nm]) predictions
    (and (B, S/4, S/4, npr) prototypes); NMS stays on the host."""
    from ..config import Config
    from ..convert.from_jax import yolo_state_dict_from_jax
    from ..models.yolo import decode_predictions, init_state_dict
    from ..train.checkpoint import load_checkpoint
    from ..utils.device import resolve_device
    from .yolo_train import build_yolo_model
    dev = resolve_device(args.device)
    model = build_yolo_model(Config.fromfile(args.config), device=dev)
    cfg = model.cfg
    if args.checkpoint:
        variables, _, _ = load_checkpoint(args.checkpoint)
        model.load_state_dict(yolo_state_dict_from_jax(variables, cfg))
    else:
        model.load_state_dict(init_state_dict(cfg, seed=0))
    seg = cfg.masks > 0

    def forward(m, x):
        out = m(x)
        if seg:
            maps, proto = out
            return decode_predictions(maps, cfg), proto
        return decode_predictions(out, cfg)

    size = cfg.img_size
    images = torch.from_numpy(np.random.default_rng(0).random(
        (args.batch, size, size, 3)).astype(np.float32)).to(dev)
    out = export_program(model, forward, images, args.output,
                         EXPORT_TOL["float32"])
    print(json.dumps({"output": args.output, "bytes": out["bytes"],
                      "in_shape": list(images.shape), "seg": seg,
                      "platforms": [dev.type]}))


def flow_extraction(args):
    """Video -> quantized Farneback flow jpgs (misc/flow_extraction.py);
    cv2 is imported first, so on a machine without it the tool raises
    ImportError naming cv2."""
    import cv2

    from ..io.native import NativeVideoReader

    reader = NativeVideoReader(args.input)
    n = len(reader)
    os.makedirs(args.dest, exist_ok=True)
    bound = args.bound
    # stream in bounded chunks (a whole-video decode would exhaust host
    # memory on long inputs); keep one frame of overlap for the i -> i+1
    # flow pair
    chunk = 256
    prev_rgb = prev_gray = None
    written = 0
    for base in range(0, n, chunk):
        frames = reader.get_batch(list(range(base, min(base + chunk, n))))
        for off, frame in enumerate(frames):
            g = cv2.cvtColor(frame, cv2.COLOR_RGB2GRAY)
            if prev_gray is not None:
                i = base + off - 1
                flow = cv2.calcOpticalFlowFarneback(
                    prev_gray, g, None, 0.5, 3, 15, 3, 5, 1.2, 0)
                q = np.clip(flow, -bound, bound)
                q = ((q + bound) * (255.0 / (2 * bound))).astype(np.uint8)
                cv2.imwrite(os.path.join(args.dest, f"flow_x_{i:05d}.jpg"),
                            q[..., 0])
                cv2.imwrite(os.path.join(args.dest, f"flow_y_{i:05d}.jpg"),
                            q[..., 1])
                if args.save_rgb:
                    cv2.imwrite(os.path.join(args.dest, f"img_{i:05d}.jpg"),
                                prev_rgb[..., ::-1])
                written += 1
            prev_gray, prev_rgb = g, frame
    reader.release()
    print(f"wrote {written} flow frame pairs to {args.dest}")


def bsn_pgm(args):
    """TEM curves (<tem_dir>/<vid>.npz: action/start/end (T,)) + optional
    ActivityNet-style gt json -> per-video proposals csv
    (tmin,tmax,tmin_score,tmax_score,score,match_iou) + BSP features."""
    from ..data.datasets_extra import ActivityNetDataset
    from ..metrics.proposals import pairwise_temporal_iou
    from ..models.bsn import match_boundaries, proposal_features

    gt_by_video = {}
    if args.ann_file:
        ds = ActivityNetDataset(args.ann_file, feature_prefix="",
                                temporal_dim=1)
        gt_by_video = {v["video"]: v["segments"] for v in ds.videos}

    os.makedirs(args.proposals_dir, exist_ok=True)
    os.makedirs(args.features_dir, exist_ok=True)
    count = 0
    for name in sorted(os.listdir(args.tem_dir)):
        if not name.endswith(".npz"):
            continue
        vid = name[:-4]
        tem = np.load(os.path.join(args.tem_dir, name))
        action, start, end = tem["action"], tem["start"], tem["end"]
        T = len(action)
        props = match_boundaries(start, end,
                                 max_proposals=args.max_proposals)
        if props.size == 0:
            # still write the files: the PEM dataset LoadProposals
            # np.loadtxt's every annotated video's csv — a missing file
            # would crash training mid-epoch.  One zero-score full-span
            # placeholder row keeps the contract.
            rows = np.asarray([[0.0, 1.0, 0.0, 0.0, 0.0, 0.0]],
                              np.float32)
            np.savetxt(os.path.join(args.proposals_dir, vid + ".csv"),
                       rows, delimiter=",", fmt="%.6f",
                       header="tmin,tmax,tmin_score,tmax_score,score,"
                              "match_iou")
            np.save(os.path.join(args.features_dir, vid + ".npy"),
                    proposal_features(
                        action, np.asarray([[0, T - 1, 0.0]],
                                           np.float32)))
            count += 1
            continue
        tmin, tmax = props[:, 0] / T, props[:, 1] / T
        rows = np.stack([
            tmin, tmax,
            start[props[:, 0].astype(int)],
            end[props[:, 1].astype(int)],
            props[:, 2],
            np.zeros(len(props), np.float32),
        ], axis=1)
        gt = gt_by_video.get(vid)
        if gt is not None and len(gt):
            iou, = (pairwise_temporal_iou(rows[:, :2], gt),)
            rows[:, 5] = iou.max(axis=0)
        np.savetxt(os.path.join(args.proposals_dir, vid + ".csv"), rows,
                   delimiter=",", fmt="%.6f",
                   header="tmin,tmax,tmin_score,tmax_score,score,match_iou")
        np.save(os.path.join(args.features_dir, vid + ".npy"),
                proposal_features(action, props))
        count += 1
    print(f"generated proposals for {count} videos")


def publish_model(args):
    with open(args.input, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:8]
    root, ext = os.path.splitext(args.input)
    out = f"{root}-{digest}{ext}"
    os.replace(args.input, out)
    print(out)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("flow_extraction")
    p.add_argument("--input", required=True)
    p.add_argument("--dest", required=True)
    p.add_argument("--bound", type=float, default=20.0)
    p.add_argument("--save_rgb", action="store_true")
    p.set_defaults(fn=flow_extraction)

    p = sub.add_parser("bsn_pgm")
    p.add_argument("--tem_dir", required=True)
    p.add_argument("--proposals_dir", required=True)
    p.add_argument("--features_dir", required=True)
    p.add_argument("--ann_file", default=None)
    p.add_argument("--max_proposals", type=int, default=200)
    p.set_defaults(fn=bsn_pgm)

    p = sub.add_parser("publish_model")
    p.add_argument("--input", required=True)
    p.set_defaults(fn=publish_model)

    p = sub.add_parser("export_model")
    p.add_argument("--output", required=True)
    p.add_argument("--preset", choices=("tiny", "vitb32"), default="vitb32")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--device", default=None,
                   help="where the program is traced and checked; default: "
                        "the CUDA device")
    p.set_defaults(fn=export_model)

    p = sub.add_parser("export_yolo")
    p.add_argument("config")
    p.add_argument("--output", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--device", default=None,
                   help="where the program is traced and checked; default: "
                        "the CUDA device")
    p.set_defaults(fn=export_yolo)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main() or 0)
