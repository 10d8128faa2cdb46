"""How close `chip_smoke.py`'s stats-step verdict sits to its bounds
across f32 summation orders (step 19b's recipes, batch 1, the training
init): one float64 run on the card, the f32 step on the CPU at each
thread count given and once on the card, then the verdict of the card
against every pair of CPU runs (the pair's first run sets the group
bounds, both gate the per-tensor ones), and of each other CPU run held
as if it were the card.  Also the worst error from float64 among TIN's
offset- and weight-net tensors on each device.

Run from the repository root on a machine with a card:

    python -m cross_modal_video_engine_tpu_torch.bench.step_orders \\
        tin_r50_1x1x8 --threads 8,4,2,1 [--blend apart]

`--blend apart` swaps TIN's linear_sampler for the blend w0 d0 +
(1 - w0) d1 (the JAX package's form) to read what it costs in f32.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]


def blend_apart(data, offset):
    """linear_sampler written as w0 d0 + (1 - w0) d1."""
    from cross_modal_video_engine_tpu_torch.models import tin_mobilenet
    n, t, f, h, w = data.shape
    floor = torch.floor(offset)
    flat = data.reshape(n, t, f, h * w)
    d0 = tin_mobilenet.tin_shift(flat, floor.long())
    d1 = tin_mobilenet.tin_shift(flat, floor.long() + 1)
    w0 = torch.repeat_interleave(1.0 - (offset - floor),
                                 f // offset.shape[1], 1)[:, None, :, None]
    return (w0 * d0 + (1.0 - w0) * d1).reshape(n, t, f, h, w)


def net_error(run, truth, tt):
    """The worst |g - truth| / |truth| among TIN's offset- and weight-net
    tensors, and its tensor (None for other recipes)."""
    worst = [(float(((run["grads"][n] - t) ** 2).sum() / tt[n]) ** 0.5, n)
             for n, t in truth.items() if "_net." in n and tt[n]]
    return max(worst) if worst else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("recipes", help="comma-separated keys of CNN19")
    ap.add_argument("--threads", default="8,4,2,1")
    ap.add_argument("--blend", choices=("difference", "apart"),
                    default="difference")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("step_orders: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from cross_modal_video_engine_tpu_torch.bench import serve as bserve
    from cross_modal_video_engine_tpu_torch.data.pipelines import (
        build_pipeline, with_reader)
    from cross_modal_video_engine_tpu_torch.models import tin_mobilenet
    from cross_modal_video_engine_tpu_torch.train.recognition_trainer import (
        RecognitionTrainConfig)
    from cross_modal_video_engine_tpu_torch.utils.device import card_line

    if args.blend == "apart":
        tin_mobilenet.linear_sampler = blend_apart
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, cpu_dev = torch.device("cuda", 0), torch.device("cpu")
    threads = [int(x) for x in args.threads.split(",")]
    own = torch.get_num_threads()
    card = card_line()
    print(f"{card}; torch's threads {own}; blend {args.blend}", flush=True)
    videos = bserve.seeded_videos(cs.TRAIN18_VIDEOS, seed=19)
    names = sorted(videos)
    for name in args.recipes.split(","):
        cfg = cs.shipped_training_config(cs.CNN_CONFIGS / cs.CNN19[name])
        pipe = build_pipeline(with_reader(cfg["data.pipeline"],
                                          videos.__getitem__))
        clips = np.stack([pipe({"filename": n, "start_index": 0})["imgs"][0]
                          for n in names[:cs.TRAIN19_CPU_BATCH]]).astype(
                              np.float32)
        labels = (np.arange(cs.TRAIN19_CPU_BATCH) * 7) \
            % cfg["model.num_classes"]
        tcfg = RecognitionTrainConfig(**dict(cfg["optimizer"],
                                             warmup_steps=0))
        f64 = cs._f64_run(cfg, dev, None, clips, labels)
        cpus = {}
        for th in threads:
            torch.set_num_threads(th)
            cpus[th] = cs._step_run(cfg, cpu_dev, None, clips, labels,
                                    False)
        torch.set_num_threads(own)
        on_card = cs._step_run(cfg, dev, None, clips, labels, False)
        ref = cs._reference(on_card, f64)
        errors = {"card": net_error(on_card, ref["truth"], ref["tt"])}
        errors.update({f"cpu{th}": net_error(run, ref["truth"], ref["tt"])
                       for th, run in cpus.items()})
        print(f"{name} worst offset/weight-net error from float64: "
              f"{json.dumps(errors)}", flush=True)
        counts = {"card": [0, 0], "cpu": [0, 0]}
        for a in threads:
            for b in threads:
                if b >= a:
                    continue
                pair = cs._reference(cpus[a], f64, cpus[b])
                held = [("card", on_card)] + [
                    (f"cpu{c}", cpus[c]) for c in threads if c not in (a, b)]
                for who, run in held:
                    bad, read = cs._step_verdict(run, cpus[a], f64, pair,
                                                 tcfg, False)
                    kind = "card" if who == "card" else "cpu"
                    counts[kind][0] += bool(bad)
                    counts[kind][1] += 1
                    print(f"{name} CPU pair {a},{b} threads, held: {who}: "
                          f"failed {bad} groups {read['bad_groups']} "
                          f"tensors {read['bad_tensors'][:3]}", flush=True)
                if (a, b) == (own, max(1, own // 2)):
                    planted = cs._planted(on_card, cpus[a], f64, pair, tcfg,
                                          False)
                    print(f"{name} planted faults against the pair {a},{b}:"
                          f" " + json.dumps({k: v.get("refused", v.get(
                              "refused_in")) for k, v in planted.items()})
                          + f" of {planted['one zero tensor']['of']} tensors",
                          flush=True)
        print(f"{name} verdicts failed: the card {counts['card'][0]} of "
              f"{counts['card'][1]}, a CPU run held as the card "
              f"{counts['cpu'][0]} of {counts['cpu'][1]}; on {card}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
