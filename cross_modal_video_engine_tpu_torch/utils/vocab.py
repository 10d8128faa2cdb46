"""Caption vocabulary.

A copy of cross_modal_video_engine_tpu/utils/vocab.py.

Behavioral parity with the reference LINAS-engine/util/vocab.py:15-87:
  * `clean_str` keeps only [A-Za-z0-9], lowercases, splits on whitespace
    (vocab.py:47-49).
  * rnn-style vocabularies reserve <pad>/<start>/<end>/<unk> as ids 0..3;
    bow-style vocabularies have no special tokens and raise on OOV lookups
    performed through `__call__` (bow callers guard with `in word2idx`).
  * `build_vocab` keeps words whose corpus frequency >= threshold, insertion
    ordered (Counter order = first-seen order, matching the reference).
"""

from __future__ import annotations

import json
import pickle
import re
from collections import Counter
from typing import Iterable, List, Tuple

_CLEAN_RE = re.compile(r"[^A-Za-z0-9]")

SPECIAL_TOKENS = ("<pad>", "<start>", "<end>", "<unk>")


def clean_str(string: str) -> List[str]:
    return _CLEAN_RE.sub(" ", string).strip().lower().split()


class Vocabulary:
    """word <-> index mapping."""

    def __init__(self, text_style: str = "rnn"):
        self.word2idx = {}
        self.idx2word = {}
        self.idx = 0
        self.text_style = text_style

    def add_word(self, word: str) -> None:
        if word not in self.word2idx:
            self.word2idx[word] = self.idx
            self.idx2word[self.idx] = word
            self.idx += 1

    def __call__(self, word: str) -> int:
        if word not in self.word2idx and "bow" not in self.text_style:
            return self.word2idx["<unk>"]
        return self.word2idx[word]

    def __len__(self) -> int:
        return len(self.word2idx)

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {"text_style": self.text_style,
                 "words": [self.idx2word[i] for i in range(self.idx)]},
                f,
            )

    @classmethod
    def load(cls, path: str) -> "Vocabulary":
        if path.endswith(".pkl"):
            # Reference pickles were written by util/vocab.py, so the
            # class is recorded as __main__.Vocabulary (or
            # util.vocab.Vocabulary) — neither importable here.  A
            # plain pickle.load would raise AttributeError before any
            # duck typing; map every *.Vocabulary onto a bare shim.
            class _Shim:
                pass

            class _Unpickler(pickle.Unpickler):
                def find_class(self, module, name):
                    if name == "Vocabulary":
                        return _Shim
                    return super().find_class(module, name)

            with open(path, "rb") as f:
                obj = _Unpickler(f).load()
            vocab = cls(getattr(obj, "text_style", "rnn"))
            for i in range(len(obj.word2idx)):
                vocab.add_word(obj.idx2word[i])
            return vocab
        with open(path) as f:
            data = json.load(f)
        vocab = cls(data["text_style"])
        for w in data["words"]:
            vocab.add_word(w)
        return vocab


def captions_from_txt(path: str) -> List[Tuple[str, str]]:
    """Parse the `cap_id caption...` format (vocab.py:90-96)."""
    out = []
    with open(path) as reader:
        for line in reader:
            line = line.strip()
            if not line:
                continue
            cap_id, caption = line.split(" ", 1)
            out.append((cap_id, caption.strip()))
    return out


def build_vocab(
    captions: Iterable[str], text_style: str = "rnn", threshold: int = 4
) -> Tuple[Vocabulary, Counter]:
    counter: Counter = Counter()
    for caption in captions:
        counter.update(clean_str(caption.lower()))

    words = [w for w, c in counter.items() if c >= threshold]

    vocab = Vocabulary(text_style)
    if "rnn" in text_style:
        for tok in SPECIAL_TOKENS:
            vocab.add_word(tok)
    for w in words:
        vocab.add_word(w)
    return vocab, counter


def caption_to_ids(vocab: Vocabulary, caption: str, add_bos_eos: bool = True) -> List[int]:
    """Tokenize a caption to rnn ids with <start>/<end> framing, matching the
    LINAS data provider (tag_data_provider.py:256-266)."""
    ids = []
    if add_bos_eos:
        ids.append(vocab("<start>"))
    ids.extend(vocab(w) for w in clean_str(caption))
    if add_bos_eos:
        ids.append(vocab("<end>"))
    return ids
