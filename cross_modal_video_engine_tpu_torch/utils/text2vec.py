"""Text vectorizers: bag-of-words and mean word2vec.

A copy of cross_modal_video_engine_tpu/utils/text2vec.py, with its own
registry dict in place of utils/registry.py's TEXT_ENCODERS.  Parity
targets: LINAS-engine/util/text2vec.py:43-123.  Differences from the
reference are deliberate vectorization only:
  * `batch_mapping` produces a dense (N, ndims) float32 matrix in one shot
    so the result can go straight to the device.
  * OOV handling matches: BoW counts only in-vocab words and returns None
    when nothing matched; AveWord2Vec averages found word vectors.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..io.bigfile import BigFile
from .vocab import Vocabulary, clean_str

# name -> encoder class (the reference's NAME_TO_ENCODER)
TEXT_ENCODERS: Dict[str, type] = {}


def _register(name: str):
    def deco(cls):
        if name in TEXT_ENCODERS:
            raise KeyError(f"{name!r} already registered")
        TEXT_ENCODERS[name] = cls
        return cls
    return deco


class Text2VecBase:
    def __init__(self, ndims: int = 0, l1_norm: bool = False, l2_norm: bool = False):
        self.ndims = ndims
        self.l1_norm = l1_norm
        self.l2_norm = l2_norm
        assert not (l1_norm and l2_norm), "choose at most one norm"

    def preprocess(self, query: str, clear: bool = True) -> List[str]:
        return clean_str(query) if clear else query.strip().split()

    def _norm(self, vec: np.ndarray) -> np.ndarray:
        if self.l1_norm:
            s = np.sum(np.abs(vec))
            return vec / s if s > 0 else vec
        if self.l2_norm:
            s = np.sqrt(np.sum(vec * vec))
            return vec / s if s > 0 else vec
        return vec

    def mapping(self, query: str, clear: bool = True) -> Optional[np.ndarray]:
        raise NotImplementedError

    def batch_mapping(self, queries: Sequence[str], clear: bool = True) -> np.ndarray:
        """Dense (N, ndims) matrix; rows with no in-vocab token are zero."""
        out = np.zeros((len(queries), self.ndims), dtype=np.float32)
        for i, q in enumerate(queries):
            v = self.mapping(q, clear)
            if v is not None:
                out[i] = v
        return out


@_register("bow")
class Bow2Vec(Text2VecBase):
    def __init__(self, vocab: Vocabulary, ndims: int = 0,
                 l1_norm: bool = False, l2_norm: bool = False):
        super().__init__(ndims or len(vocab), l1_norm, l2_norm)
        self.vocab = vocab
        if ndims:
            assert len(vocab) == ndims, f"{len(vocab)} != {ndims}"

    def mapping(self, query: str, clear: bool = True) -> Optional[np.ndarray]:
        words = self.preprocess(query, clear)
        vec = np.zeros(self.ndims, dtype=np.float32)
        hit = False
        for w in words:
            if w in self.vocab.word2idx:
                vec[self.vocab(w)] += 1.0
                hit = True
        if not hit:
            return None
        return self._norm(vec)


@_register("word2vec")
class AveWord2Vec(Text2VecBase):
    def __init__(self, datafile: str, ndims: int = 0,
                 l1_norm: bool = False, l2_norm: bool = False):
        self.word2vec = BigFile(datafile)
        super().__init__(ndims or self.word2vec.ndims, l1_norm, l2_norm)
        if ndims:
            assert self.word2vec.ndims == ndims

    def mapping(self, query: str, clear: bool = True) -> Optional[np.ndarray]:
        words = self.preprocess(query, clear)
        found, vectors = self.word2vec.read(words)
        if not found:
            return None
        # preserve query word multiplicity, like the reference re-expansion
        # (text2vec.py:94-99)
        by_name = dict(zip(found, vectors))
        vecs = [by_name[w] for w in words if w in by_name]
        vec = np.mean(np.stack(vecs), axis=0).astype(np.float32)
        return self._norm(vec)


def get_text_encoder(name: str):
    try:
        return TEXT_ENCODERS[name]
    except KeyError:
        raise KeyError(f"{name!r} not found among the text encoders; "
                       f"available: {sorted(TEXT_ENCODERS)}") from None


def get_we_parameter(vocab: Vocabulary, w2v_dir: str) -> np.ndarray:
    """Word-embedding init matrix for the text GRU, matching
    LINAS-engine/model.py:19-32: rows from word2vec when available, else
    the reference's UNSCALED uniform(-1, 1) fallback (the OOV/special-
    token scale is part of the recipe)."""
    w2v = BigFile(w2v_dir)
    ndims = w2v.ndims
    rng = np.random.default_rng(0)
    out = np.zeros((len(vocab), ndims), dtype=np.float32)
    for i in range(len(vocab)):
        word = vocab.idx2word[i]
        if word in w2v:
            out[i] = w2v.read_one(word)
        else:
            out[i] = rng.uniform(-1, 1, ndims)
    return out
