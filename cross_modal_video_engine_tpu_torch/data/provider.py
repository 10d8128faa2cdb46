"""LINAS-style data provider.

A copy of cross_modal_video_engine_tpu/data/provider.py whose batches are
the port's `VideoBatch`/`TextBatch` on the dataset's `device` (None: the
CUDA device).  Re-implements the reference data layer (LINAS-engine/util/
tag_data_provider.py) host-side, producing fixed-shape device batches:

  * captions file `vid#n caption` -> captions / cap_ids / video_ids
    (tag_data_provider.py:203-214);
  * BigFile frame features, subsampled to VIDEO_MAX_LEN=64 uniformly at
    collate (tag_data_provider.py:34-45);
  * support-set captions: the video's other captions, sampled to
    `support_set_number` (tag_data_provider.py:263-270);
  * BoW + <start>/<end>-framed rnn ids per caption (:292-315);
  * optional weighted tag one-hots (:276-287).

Unlike the torch DataLoader (per-sample python, workers, dynamic shapes),
batches are built dense in numpy with static (batch, time) shapes, so every
call sees one shape; the tail batch is padded and `n_valid` reports the
real rows.
"""

from __future__ import annotations

import ast
import os
import random
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..io.bigfile import BigFile
from ..models.dual_encoding import (TextBatch, VideoBatch, make_text_batch,
                                    make_video_batch)
from ..utils.device import resolve_device
from ..utils.text2vec import Bow2Vec
from ..utils.vocab import Vocabulary, caption_to_ids

VIDEO_MAX_LEN = 64


def get_video_id(cap_id: str) -> str:
    return cap_id.split("#", 1)[0]


def read_video2frames(path: str) -> Dict[str, List[str]]:
    """video2frames.txt: either a python dict literal (reference format) or
    `vid frame1 frame2 ...` lines."""
    with open(path) as f:
        content = f.read().strip()
    if content.startswith("{"):
        return ast.literal_eval(content)
    out: Dict[str, List[str]] = {}
    for line in content.splitlines():
        parts = line.split()
        if parts:
            out[parts[0]] = parts[1:]
    return out


class LinasDataset:
    def __init__(self, cap_file: str, visual_feat: BigFile,
                 video2frames: Dict[str, List[str]],
                 bow2vec: Optional[Bow2Vec], vocab: Optional[Vocabulary],
                 support_set_number: int = 8,
                 tag_path: Optional[str] = None,
                 tag_vocab_list: Optional[List[str]] = None,
                 max_words: int = 32, max_frames: int = VIDEO_MAX_LEN,
                 device=None):
        self.captions: Dict[str, str] = {}
        self.ref_captions: Dict[str, List[str]] = {}
        self.cap_ids: List[str] = []
        video_ids: List[str] = []
        with open(cap_file) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                cap_id, caption = line.split(" ", 1)
                vid = get_video_id(cap_id)
                self.captions[cap_id] = caption
                self.ref_captions.setdefault(vid, []).append(caption)
                if len(self.ref_captions[vid]) == 1:   # first caption seen
                    video_ids.append(vid)
                self.cap_ids.append(cap_id)
        self.video_ids = video_ids
        self.visual_feat = visual_feat
        self.video2frames = video2frames
        self.bow2vec = bow2vec
        self.vocab = vocab
        self.support_set_number = support_set_number
        self.max_words = max_words
        self.max_frames = max_frames
        self.device = resolve_device(device)

        # weighted tags (tag_data_provider.py:225-241)
        self.tag_vocab_list = tag_vocab_list or []
        self.tag2idx = {t: i for i, t in enumerate(self.tag_vocab_list)}
        self.vid2tags: Dict[str, List[Tuple[str, float]]] = {}
        if tag_path and os.path.exists(tag_path):
            for line in open(tag_path):
                parts = line.strip().split("\t", 1)
                if len(parts) < 2:
                    self.vid2tags[parts[0]] = []
                    continue
                vid, or_tags = parts
                items = or_tags.strip().split()
                tags = [x.split(":")[0] for x in items]
                scores = np.array([float(x.split(":")[1]) for x in items])
                scores = scores / scores.max()
                self.vid2tags[vid] = list(zip(tags, scores))

    def __len__(self) -> int:
        return len(self.cap_ids)

    # ---- single-item processing ------------------------------------------
    def frames_of(self, video_id: str) -> np.ndarray:
        frame_ids = self.video2frames[video_id]
        return self.visual_feat.read_batch(frame_ids)

    def process_cap(self, caption: str) -> Tuple[np.ndarray, List[int]]:
        if self.bow2vec is not None:
            bow = self.bow2vec.mapping(caption)
            if bow is None:
                bow = np.zeros(self.bow2vec.ndims, np.float32)
        else:
            bow = np.zeros(0, np.float32)
        ids = caption_to_ids(self.vocab, caption) if self.vocab else []
        return bow, ids

    def tag_onehot(self, video_id: str) -> np.ndarray:
        vec = np.zeros(len(self.tag_vocab_list), np.float32)
        for tag, score in self.vid2tags.get(video_id, []):
            if tag in self.tag2idx:
                vec[self.tag2idx[tag]] = score
        return vec

    # ---- batch iterators ---------------------------------------------------
    def video_batches(self, batch_size: int) -> Iterator[Tuple[VideoBatch, int]]:
        """Unique-video batches in self.video_ids order; tail padded."""
        for i in range(0, len(self.video_ids), batch_size):
            chunk = self.video_ids[i:i + batch_size]
            n = len(chunk)
            feats = [self.frames_of(v) for v in chunk]
            while len(feats) < batch_size:  # pad tail with first element
                feats.append(feats[0])
            yield make_video_batch(feats, self.max_frames, self.device), n

    def text_batches(self, batch_size: int,
                     cap_ids: Optional[Sequence[str]] = None
                     ) -> Iterator[Tuple[TextBatch, int]]:
        cap_ids = list(cap_ids if cap_ids is not None else self.cap_ids)
        for i in range(0, len(cap_ids), batch_size):
            chunk = cap_ids[i:i + batch_size]
            n = len(chunk)
            bows, idss = [], []
            for cid in chunk:
                bow, ids = self.process_cap(self.captions[cid])
                bows.append(bow)
                idss.append(ids[: self.max_words])
            while len(bows) < batch_size:
                bows.append(bows[0])
                idss.append(idss[0])
            yield make_text_batch(idss, np.stack(bows), self.max_words,
                                  self.device), n

    def support_for(self, cap_id: str, rng: random.Random) -> List[str]:
        vid = get_video_id(cap_id)
        caps = list(self.ref_captions[vid])
        own = self.captions[cap_id]
        if self.support_set_number < 20 and own in caps and \
                len(caps) > self.support_set_number:
            caps.remove(own)
        if len(caps) >= self.support_set_number:
            return rng.sample(caps, self.support_set_number)
        # pad by cycling (rare short videos)
        out = list(caps)
        while len(out) < self.support_set_number:
            out.append(caps[len(out) % len(caps)])
        return out

    def train_batches(self, batch_size: int, seed: int = 0, shuffle: bool = True
                      ) -> Iterator[Tuple[VideoBatch, TextBatch, TextBatch, int]]:
        """(videos, text, support, n_valid) triples; epochs drop the ragged
        tail like the reference DataLoader(drop_last default False — we pad)."""
        rng = random.Random(seed)
        order = list(range(len(self.cap_ids)))
        if shuffle:
            rng.shuffle(order)
        for i in range(0, len(order), batch_size):
            sel = order[i:i + batch_size]
            n = len(sel)
            while len(sel) < batch_size:
                sel.append(sel[0])
            cap_chunk = [self.cap_ids[j] for j in sel]
            feats = [self.frames_of(get_video_id(c)) for c in cap_chunk]
            videos = make_video_batch(feats, self.max_frames, self.device)

            bows, idss = [], []
            s_bows, s_idss = [], []
            for cid in cap_chunk:
                bow, ids = self.process_cap(self.captions[cid])
                bows.append(bow)
                idss.append(ids[: self.max_words])
                sb, si = [], []
                for cap in self.support_for(cid, rng):
                    b, x = self.process_cap(cap)
                    sb.append(b)
                    si.append(x[: self.max_words])
                s_bows.append(np.stack(sb))
                s_idss.append(si)
            text = make_text_batch(idss, np.stack(bows), self.max_words,
                                   self.device)

            S = self.support_set_number
            B = batch_size
            sup_ids = np.zeros((B, S, self.max_words), np.int64)
            sup_mask = np.zeros((B, S, self.max_words), np.float32)
            sup_len = np.zeros((B, S), np.int32)
            for b in range(B):
                for s in range(S):
                    ids = s_idss[b][s]
                    sup_ids[b, s, :len(ids)] = ids
                    sup_mask[b, s, :len(ids)] = 1.0
                    sup_len[b, s] = len(ids)
            support = TextBatch(*(torch.from_numpy(a).to(self.device) for a in (
                sup_ids, np.stack(s_bows).astype(np.float32), sup_len,
                sup_mask)))
            yield videos, text, support, n
