"""Data tools: the SSN proposal-file denormalization.

Counterpart of cross_modal_video_engine_tpu/cli/data_tools.py, of which
the port holds `denormalize_proposals`: a `normalized_*` SSN proposal
file ([0, 1] spans) to frame units, from the frame counts of a rawframes
tree (MCT/tools/data/denormalize_proposal_file.py:9-51); its file is
byte-equal to the JAX tool's.  The other subcommands are refused: they
come with the host tools, ROADMAP.md queue 1 item 8i.

Usage: python -m cross_modal_video_engine_tpu_torch.cli.data_tools
    denormalize_proposals --input normalized_X.txt --frames_dir D
"""

from __future__ import annotations

import argparse
import os
import sys

UNPORTED = ("txt2bin", "combine_features", "format_check", "build_vocab",
            "build_tags", "gen_videolist", "organize_masks", "build_file_list",
            "build_rawframes", "extract_audio", "build_audio_features")


def refuse(args):
    from ..train.recognition_trainer import not_ported
    raise NotImplementedError(not_ported(f"the {args.cmd} tool", "8i"))


def denormalize_proposals(args):
    """Convert a `normalized_*` SSN proposal file ([0,1] spans) to frame
    units using per-video frame counts from the rawframes tree
    (MCT/tools/data/denormalize_proposal_file.py:9-51)."""
    from ..data.datasets_extra import load_localize_proposal_file

    counts = {d: len(os.listdir(os.path.join(args.frames_dir, d)))
              for d in os.listdir(args.frames_dir)
              if os.path.isdir(os.path.join(args.frames_dir, d))}
    out_path = args.output or args.input.replace("normalized_", "")
    blocks = []
    for i, (vid, _nf, fps, gt, prop) in enumerate(
            load_localize_proposal_file(args.input)):
        n = counts[vid]
        gt_lines = "".join(
            f"{int(g[0])} {int(g[1] * n)} {int(g[2] * n)}\n" for g in gt)
        prop_lines = "".join(
            f"{int(p[0])} {p[1]:.04f} {p[2]:.04f} "
            f"{int(p[3] * n)} {int(p[4] * n)}\n" for p in prop)
        blocks.append(f"# {i}\n{vid}\n{n}\n1\n{len(gt)}\n{gt_lines}"
                      f"{len(prop)}\n{prop_lines}")
    with open(out_path, "w") as f:
        f.writelines(blocks)
    print(f"denormalized {len(blocks)} videos -> {out_path}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("denormalize_proposals")
    p.add_argument("--input", required=True)
    p.add_argument("--frames_dir", required=True)
    p.add_argument("--output", default=None)
    p.set_defaults(fn=denormalize_proposals)

    for cmd in UNPORTED:
        sub.add_parser(cmd).set_defaults(fn=refuse)

    # a refused subcommand takes whatever arguments the JAX tool takes
    args, extra = parser.parse_known_args(argv)
    if extra and args.fn is not refuse:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main() or 0)
