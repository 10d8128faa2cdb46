"""Data preparation utilities.

Counterpart of cross_modal_video_engine_tpu/cli/data_tools.py; each
subcommand writes the bytes the JAX tool writes from the same inputs.

Parity surfaces for the LINAS util tools:
  * txt2bin          (util/txt2bin.py:21-76: `id f f f...` text -> BigFile)
  * combine_features (util/combine_features.py: concat two BigFiles along
                      the feature axis for shared ids)
  * format_check     (util/format_check.py:5-33: caption/feature
                      consistency checks)
  * build_vocab      (util/vocab.py main: caption file -> vocab json)
  * build_tags       (util/get_concept_tags.py: captions -> weighted tag
                      file + tag vocab)

The MCT concept-bank organization tools (MCT/tools/ctm/):
  * gen_videolist    (gen_videolist.py: class dirs -> per-class video-list
                      txts for raw videos and concept-masked videos; these
                      lists feed cli/ctv_build and cli/dump_features)
  * organize_masks   (move_files.py: flat <concept>/<video> mask output ->
                      <class>/<concept>/<video> tree keyed by which class
                      each raw video belongs to)

And the MCT dataset tools (MCT/tools/data/):
  * build_file_list  (class tree -> `path label` lists)
  * build_rawframes  (videos -> img_%05d.jpg frame dirs; needs cv2 to
                      write the jpgs and refuses with ImportError where
                      cv2 is missing)
  * extract_audio    (containers -> mono 16 kHz wav through the native
                      libav layer, io/native.read_audio)
  * denormalize_proposals (a `normalized_*` SSN proposal file to frame
                      units, MCT/tools/data/denormalize_proposal_file.py)

`build_audio_features` is refused: it needs the audio pipeline's
`MelSpectrogram`, ROADMAP.md queue 1 item 8g.

Usage: python -m cross_modal_video_engine_tpu_torch.cli.data_tools CMD ...
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ..io.bigfile import BigFile, write_bigfile
from ..utils.concept_tags import (build_tag_vocab, video_tag_scores,
                                  write_tag_file)
from ..utils.vocab import build_vocab, captions_from_txt


def txt2bin(args):
    names, rows = [], []
    with open(args.input) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            names.append(parts[0])
            rows.append(np.asarray(parts[1:], np.float32))
    mat = np.stack(rows)
    write_bigfile(args.output, names, mat)
    print(f"wrote {mat.shape[0]}x{mat.shape[1]} features to {args.output}")


def combine_features(args):
    a, b = BigFile(args.a), BigFile(args.b)
    shared = [n for n in a.names if n in b]
    mat = np.concatenate([a.read_batch(shared), b.read_batch(shared)], axis=1)
    write_bigfile(args.output, shared, mat)
    print(f"combined {len(shared)} ids -> {mat.shape[1]} dims at {args.output}")


def format_check(args):
    ok = True
    caps = captions_from_txt(args.captions)
    seen = set()
    for cap_id, cap in caps:
        if "#" not in cap_id:
            print(f"BAD cap id (no #): {cap_id}")
            ok = False
        if cap_id in seen:
            print(f"DUPLICATE cap id: {cap_id}")
            ok = False
        seen.add(cap_id)
        if not cap.strip():
            print(f"EMPTY caption: {cap_id}")
            ok = False
    if args.features:
        bf = BigFile(args.features)
        vids = {c.split("#", 1)[0] for c, _ in caps}
        if args.video2frames:
            from ..data.provider import read_video2frames
            v2f = read_video2frames(args.video2frames)
            for v in sorted(vids):
                if v not in v2f:
                    print(f"MISSING video2frames entry: {v}")
                    ok = False
                    continue
                for fid in v2f[v]:
                    if fid not in bf:
                        print(f"MISSING feature row: {fid}")
                        ok = False
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


def build_vocab_cmd(args):
    caps = [c for _, c in captions_from_txt(args.captions)]
    for style in ("rnn", "bow"):
        vocab, counter = build_vocab(caps, style, args.threshold)
        d = os.path.join(args.output, style)
        os.makedirs(d, exist_ok=True)
        vocab.save(os.path.join(d, f"word_vocab_{args.threshold}.json"))
        print(f"{style}: {len(vocab)} words")


def build_tags_cmd(args):
    caps = captions_from_txt(args.captions)
    per_video = {}
    for cap_id, cap in caps:
        per_video.setdefault(cap_id.split("#", 1)[0], []).append(cap)
    vocab = build_tag_vocab([c for cl in per_video.values() for c in cl],
                            args.vocab_size)
    scores = video_tag_scores(per_video, vocab)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    write_tag_file(args.output, scores)
    with open(args.output + ".vocab.json", "w") as f:
        json.dump(vocab, f)
    print(f"wrote tags for {len(scores)} videos, vocab {len(vocab)}")


def gen_videolist(args):
    """Per-class `path 0` list files (ctm/gen_videolist.py semantics)."""
    made = 0
    if args.train_root:
        out = os.path.join(args.output, "trainlist_classwise")
        os.makedirs(out, exist_ok=True)
        for cls in sorted(os.listdir(args.train_root)):
            cdir = os.path.join(args.train_root, cls)
            if not os.path.isdir(cdir):
                continue
            with open(os.path.join(out, f"{cls}.txt"), "w") as f:
                for v in sorted(os.listdir(cdir)):
                    f.write(f"{os.path.join(cdir, v)} 0\n")
            made += 1
    if args.mask_root:
        out = os.path.join(args.output, "conceptlist_classwise")
        os.makedirs(out, exist_ok=True)
        for cls in sorted(os.listdir(args.mask_root)):
            cdir = os.path.join(args.mask_root, cls)
            if not os.path.isdir(cdir):
                continue
            with open(os.path.join(out, f"{cls}.txt"), "w") as f:
                for concept in sorted(os.listdir(cdir)):
                    kdir = os.path.join(cdir, concept)
                    for v in sorted(os.listdir(kdir)):
                        f.write(f"{os.path.join(kdir, v)} 0\n")
            made += 1
    print(f"wrote {made} class lists under {args.output}")


def organize_masks(args):
    """Regroup flat <concept>/<video> masked output into
    <class>/<concept>/<video> using the raw-video class layout
    (ctm/move_files.py semantics; copies, does not delete)."""
    import shutil

    class_videos = {
        cls: set(os.listdir(os.path.join(args.train_root, cls)))
        for cls in os.listdir(args.train_root)
        if os.path.isdir(os.path.join(args.train_root, cls))}
    copied = 0
    for concept in sorted(os.listdir(args.mask_root)):
        cdir = os.path.join(args.mask_root, concept)
        if not os.path.isdir(cdir):
            continue
        for video in os.listdir(cdir):
            for cls, vids in class_videos.items():
                if video in vids:
                    dst = os.path.join(args.target_root, cls, concept)
                    os.makedirs(dst, exist_ok=True)
                    shutil.copyfile(os.path.join(cdir, video),
                                    os.path.join(dst, video))
                    copied += 1
                    break
    print(f"copied {copied} masked videos into {args.target_root}")


def build_file_list(args):
    """Class-directory tree -> `path label` annotation lists
    (MCT/tools/data/build_file_list.py semantics: sorted class names map
    to label ids; rawframes mode counts frames per dir)."""
    classes = sorted(d for d in os.listdir(args.src_dir)
                     if os.path.isdir(os.path.join(args.src_dir, d)))
    lines = []
    for label, cls in enumerate(classes):
        cdir = os.path.join(args.src_dir, cls)
        for item in sorted(os.listdir(cdir)):
            rel = os.path.join(cls, item)
            if args.format == "videos":
                lines.append(f"{rel} {label}\n")
            else:  # rawframes: `frame_dir total_frames label`
                n = len(os.listdir(os.path.join(cdir, item)))
                lines.append(f"{rel} {n} {label}\n")
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    with open(args.output, "w") as f:
        f.writelines(lines)
    with open(args.output + ".classes.txt", "w") as f:
        f.writelines(c + "\n" for c in classes)
    print(f"wrote {len(lines)} entries, {len(classes)} classes")


def build_rawframes(args):
    """Decode every video under src_dir into img_%05d.jpg frame dirs
    (MCT/tools/data/build_rawframes.py; decode via the native libav
    reader, resize short side with cv2; cv2 is imported first, so on a
    machine without it the tool raises ImportError naming cv2)."""
    import cv2

    from ..io.native import NativeVideoReader

    count = 0
    for root, _dirs, files in os.walk(args.src_dir):
        for name in sorted(files):
            if not name.endswith(tuple(args.ext.split(","))):
                continue
            src = os.path.join(root, name)
            rel = os.path.relpath(src, args.src_dir)
            dst = os.path.join(args.out_dir, os.path.splitext(rel)[0])
            os.makedirs(dst, exist_ok=True)
            reader = NativeVideoReader(src)
            n = len(reader)
            # decode in bounded chunks: materializing a whole long
            # video as uint8 RGB would exhaust host memory
            chunk = 256
            for base in range(0, n, chunk):
                frames = reader.get_batch(list(range(base,
                                                     min(base + chunk, n))))
                for i, frame in enumerate(frames, start=base):
                    if args.new_short > 0:
                        h, w = frame.shape[:2]
                        if min(h, w) > args.new_short:
                            s = args.new_short / min(h, w)
                            frame = cv2.resize(
                                frame,
                                (int(round(w * s)), int(round(h * s))))
                    cv2.imwrite(os.path.join(dst, f"img_{i + 1:05d}.jpg"),
                                frame[..., ::-1])
            reader.release()
            count += 1
    print(f"extracted frames for {count} videos into {args.out_dir}")


def extract_audio(args):
    """Video containers -> mono 16 kHz wav files
    (MCT/tools/data/extract_audio.py shells `ffmpeg -map 0:a`; here the
    native libav layer decodes + resamples in-process)."""
    import wave as wave_mod

    from ..io.native import read_audio

    done = skipped = 0
    for root, _dirs, files in os.walk(args.src_dir):
        for name in sorted(files):
            if not name.endswith(tuple(args.ext.split(","))):
                continue
            src = os.path.join(root, name)
            rel = os.path.relpath(src, args.src_dir)
            dst = os.path.join(args.out_dir,
                               os.path.splitext(rel)[0] + ".wav")
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            y = read_audio(src, args.sample_rate)
            if y is None:
                skipped += 1
                continue
            with wave_mod.open(dst, "wb") as f:
                f.setnchannels(1)
                f.setsampwidth(2)
                f.setframerate(args.sample_rate)
                f.writeframes(
                    (np.clip(y, -1, 1) * 32767).astype("<i2").tobytes())
            done += 1
    print(f"extracted {done} wavs ({skipped} without audio)")


def build_audio_features(args):
    """wav -> log-mel .npy feature maps (JAX cli/data_tools.py:275-301):
    refused until the audio pipeline ops (`MelSpectrogram`) are ported."""
    from ..train.recognition_trainer import not_ported
    raise NotImplementedError(not_ported(f"the {args.cmd} tool", "8g"))


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

    p = sub.add_parser("txt2bin")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.set_defaults(fn=txt2bin)

    p = sub.add_parser("combine_features")
    p.add_argument("--a", required=True)
    p.add_argument("--b", required=True)
    p.add_argument("--output", required=True)
    p.set_defaults(fn=combine_features)

    p = sub.add_parser("format_check")
    p.add_argument("--captions", required=True)
    p.add_argument("--features", default=None)
    p.add_argument("--video2frames", default=None)
    p.set_defaults(fn=format_check)

    p = sub.add_parser("build_vocab")
    p.add_argument("--captions", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--threshold", type=int, default=5)
    p.set_defaults(fn=build_vocab_cmd)

    p = sub.add_parser("build_tags")
    p.add_argument("--captions", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--vocab_size", type=int, default=512)
    p.set_defaults(fn=build_tags_cmd)

    p = sub.add_parser("gen_videolist")
    p.add_argument("--train_root", default=None)
    p.add_argument("--mask_root", default=None)
    p.add_argument("--output", required=True)
    p.set_defaults(fn=gen_videolist)

    p = sub.add_parser("organize_masks")
    p.add_argument("--train_root", required=True)
    p.add_argument("--mask_root", required=True)
    p.add_argument("--target_root", required=True)
    p.set_defaults(fn=organize_masks)

    p = sub.add_parser("build_file_list")
    p.add_argument("--src_dir", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--format", choices=("videos", "rawframes"),
                   default="videos")
    p.set_defaults(fn=build_file_list)

    p = sub.add_parser("build_rawframes")
    p.add_argument("--src_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--ext", default="mp4,avi,webm,mkv")
    p.add_argument("--new_short", type=int, default=0)
    p.set_defaults(fn=build_rawframes)

    p = sub.add_parser("extract_audio")
    p.add_argument("--src_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--ext", default="mp4,avi,webm,mkv")
    p.add_argument("--sample_rate", type=int, default=16000)
    p.set_defaults(fn=extract_audio)

    p = sub.add_parser("denormalize_proposals")
    p.add_argument("--input", required=True)
    p.add_argument("--frames_dir", required=True)
    p.add_argument("--output", default=None)
    p.set_defaults(fn=denormalize_proposals)

    p = sub.add_parser("build_audio_features")
    p.add_argument("--src_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--sample_rate", type=int, default=16000)
    p.add_argument("--n_mels", type=int, default=80)
    p.set_defaults(fn=build_audio_features)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main() or 0)
