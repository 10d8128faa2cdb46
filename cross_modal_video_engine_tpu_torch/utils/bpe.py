"""Byte-level BPE tokenizer (CLIP-compatible).

A copy of cross_modal_video_engine_tpu/utils/bpe.py (standard library and
numpy only): the reversible byte->unicode mapping, greedy lowest-rank pair
merging with a `</w>` word-end marker, html unescape + whitespace
normalization + lowercasing, and `<|startoftext|>` / `<|endoftext|>`
framing to a fixed context length.  `tokenize` gives the same int32 ids
and padding as the original.

The merges table is loaded from a text file ("a b" per line, optional
header).  Point it at OpenAI's published bpe_simple_vocab_16e6 merges for
checkpoint-compatible ids; tests use a table `write_toy_merges` learns.
"""

from __future__ import annotations

import functools
import gzip
import html
import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

# mirrors the CLIP tokenizer pattern: contractions, letter runs, single
# digits, punctuation runs (underscore is punctuation there, not \w)
_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|\d|(?:[^\s\w]|_)+",
    re.IGNORECASE,
)


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: Tuple[str, ...]):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class BPETokenizer:
    def __init__(self, merges_path: str):
        if merges_path.endswith(".gz"):
            with gzip.open(merges_path, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")
        else:
            with open(merges_path, encoding="utf-8") as f:
                lines = f.read().split("\n")
        # CLIP's exact slice (simple_tokenizer.py): drop the version
        # header line (it is NOT '#'-prefixed) and truncate to
        # 49152-256-2+1 merges, giving vocab_size 49408 and
        # sot/eot = 49406/49407 — the published 262k-line file would
        # otherwise produce out-of-range ids for every CLIP checkpoint.
        # Short/toy merges files (no header, < the cap) load verbatim.
        full = (len(lines) > 49152 - 256 - 2 + 1
                or (lines and "#version" in lines[0]))
        if full:
            lines = lines[1: 49152 - 256 - 2 + 1]
        elif lines and lines[0].startswith("#"):
            lines = lines[1:]          # toy files with a comment header
        merges = [tuple(l.split()) for l in lines if len(l.split()) == 2]

        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self.vocab_size = len(self.encoder)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        out: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in re.findall(_PAT, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            out.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return out

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text
                        if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def tokenize(self, texts, context_length: int = 77,
                 truncate: bool = True) -> np.ndarray:
        """(N, context_length) int32 with <sot> ids <eot> framing, like
        reference clip.tokenize (clip.py:237-264)."""
        if isinstance(texts, str):
            texts = [texts]
        result = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot] + self.encode(text) + [self.eot]
            if len(ids) > context_length:
                if not truncate:
                    raise RuntimeError(
                        f"Input {text!r} is too long for context length "
                        f"{context_length}")
                ids = ids[:context_length]
                ids[-1] = self.eot
            result[i, :len(ids)] = ids
        return result


def write_toy_merges(path: str, corpus: Sequence[str], n_merges: int = 256) -> None:
    """Learn a tiny merges table from a corpus (for tests/fixtures)."""
    from collections import Counter

    be = bytes_to_unicode()
    words = Counter()
    for text in corpus:
        text = whitespace_clean(basic_clean(text)).lower()
        for token in re.findall(_PAT, text):
            enc = "".join(be[b] for b in token.encode("utf-8"))
            words[tuple(enc[:-1]) + (enc[-1] + "</w>",)] += 1
    merges: List[Tuple[str, str]] = []
    words = dict(words)
    for _ in range(n_merges):
        pairs: Counter = Counter()
        for w, c in words.items():
            for p in zip(w[:-1], w[1:]):
                pairs[p] += c
        if not pairs:
            break
        best, cnt = pairs.most_common(1)[0]
        if cnt < 2:
            break
        merges.append(best)
        new_words = {}
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i < len(w) - 1 and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            new_words[tuple(out)] = new_words.get(tuple(out), 0) + c
        words = new_words
    with open(path, "w", encoding="utf-8") as f:
        f.write("#version: toy\n")
        f.write("\n".join(" ".join(m) for m in merges))
