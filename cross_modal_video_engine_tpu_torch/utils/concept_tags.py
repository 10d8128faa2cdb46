"""Concept tag extraction from captions.

Counterpart of cross_modal_video_engine_tpu/utils/concept_tags.py (a
copy).  `_wnl` takes the branch the JAX package takes in the same
environment: nltk's WordNet lemmatizer where nltk and its WordNet data
load, else the plural and "-ing" stripping.

Rebuild of LINAS-engine/util/get_concept_tags.py:55-112: build a weighted
tag vocabulary from captions via lemmatization + frequency, and per-video
weighted tag annotations (`vid\ttag:score ...` lines consumed by the tag
data provider).
"""

from __future__ import annotations

import functools
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

from .vocab import clean_str

_STOPWORDS = set(
    "a an the is are was were be been being to of in on at for with and or "
    "as by from this that these those it its his her their there then than "
    "so not no do does did done very while during".split())


@functools.lru_cache(maxsize=1)
def _wnl():
    """One lemmatizer + one nltk availability probe per process (the
    per-caption import/construct was pure overhead on large corpora)."""
    try:
        from nltk.stem import WordNetLemmatizer
        wnl = WordNetLemmatizer()
        wnl.lemmatize("tests", "n")     # force the data load / fail now
        return wnl
    except Exception:
        return None


def _lemmatize(words: List[str]) -> List[str]:
    wnl = _wnl()
    if wnl is not None:
        return [wnl.lemmatize(wnl.lemmatize(w, "v"), "n")
                for w in words]
    # nltk data unavailable: crude plural/ing stripping fallback
    out = []
    for w in words:
        if w.endswith("ing") and len(w) > 5:
            w = w[:-3]
        elif w.endswith("s") and not w.endswith("ss") and len(w) > 3:
            w = w[:-1]
        out.append(w)
    return out


def build_tag_vocab(captions: Iterable[str], vocab_size: int = 512
                    ) -> List[str]:
    counter: Counter = Counter()
    for cap in captions:
        words = [w for w in _lemmatize(clean_str(cap))
                 if w not in _STOPWORDS and len(w) > 1]
        counter.update(set(words))
    return [w for w, _ in counter.most_common(vocab_size)]


def video_tag_scores(video_captions: Dict[str, List[str]],
                     tag_vocab: List[str]
                     ) -> Dict[str, List[Tuple[str, float]]]:
    """Per-video weighted tags: tag weight = fraction of the video's
    captions mentioning the tag (get_concept_tags.py scoring)."""
    vocab = set(tag_vocab)
    out = {}
    for vid, caps in video_captions.items():
        counts: Counter = Counter()
        for cap in caps:
            words = set(_lemmatize(clean_str(cap)))
            counts.update(words & vocab)
        scored = [(t, c / len(caps)) for t, c in counts.most_common()]
        out[vid] = scored
    return out


def write_tag_file(path: str,
                   vid2tags: Dict[str, List[Tuple[str, float]]]) -> None:
    """`vid\ttag:score tag:score ...` lines (tag_data_provider.py:225-241
    input format)."""
    with open(path, "w") as f:
        for vid, tags in vid2tags.items():
            if not tags:
                # the reference format has no tagless lines; a bare
                # `vid\n` would hand downstream tab-splitters a
                # one-field row
                continue
            body = " ".join(f"{t}:{s:.4f}" for t, s in tags)
            f.write(f"{vid}\t{body}\n")
