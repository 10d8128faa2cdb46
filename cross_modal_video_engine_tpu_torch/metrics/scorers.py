"""Ranking metric scorers over binary relevance label lists.

Counterpart of cross_modal_video_engine_tpu/metrics/scorers.py (a copy).

Parity with LINAS-engine/basic/metric.py:5-121 formulas (AP, reciprocal
rank, precision@k, DCG@k with the 0.01757*(2^rel-1)/log2(i+1) convention,
NDCG), vectorized with numpy where profitable.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np


class MetricScorer:
    def __init__(self, k: int = 0):
        self.k = k

    def score(self, sorted_labels: Sequence[float]) -> float:
        return 0.0

    def getLength(self, sorted_labels: Sequence[float]) -> int:
        length = self.k
        if length > len(sorted_labels) or length <= 0:
            length = len(sorted_labels)
        return length

    def name(self) -> str:
        base = self.__class__.__name__.replace("Scorer", "")
        return f"{base}@{self.k}" if self.k > 0 else base


class APScorer(MetricScorer):
    def score(self, sorted_labels: Sequence[float]) -> float:
        labels = np.asarray(sorted_labels, dtype=np.float64)
        nr_relevant = int(np.sum(labels > 0))
        if nr_relevant == 0:
            return 0.0
        length = self.getLength(sorted_labels)
        head = labels[:length] >= 1
        ranks = np.nonzero(head)[0]
        if len(ranks) == 0:
            return 0.0
        prec = np.arange(1, len(ranks) + 1, dtype=np.float64) / (ranks + 1.0)
        return float(np.sum(prec) / nr_relevant)


class RRScorer(MetricScorer):
    def score(self, sorted_labels: Sequence[float]) -> float:
        labels = np.asarray(sorted_labels, dtype=np.float64)
        hits = np.nonzero(labels >= 1)[0]
        return float(1.0 / (hits[0] + 1)) if len(hits) else 0.0


class PrecisionScorer(MetricScorer):
    def score(self, sorted_labels: Sequence[float]) -> float:
        length = self.getLength(sorted_labels)
        labels = np.asarray(sorted_labels[:length], dtype=np.float64)
        return float(np.sum(labels >= 1) / length)


class NDCGScorer(PrecisionScorer):
    def score(self, sorted_labels: Sequence[float]) -> float:
        d = self.getDCG(sorted_labels)
        d2 = self.getIdealDCG(sorted_labels)
        return d / d2 if d2 != 0 else 0.0

    def getDCG(self, sorted_labels: Sequence[float]) -> float:
        length = self.getLength(sorted_labels)
        dcg = max(sorted_labels[0], 0)
        for i in range(1, length):
            rel = max(sorted_labels[i], 0)
            dcg += float(rel) / math.log(i + 1, 2)
        return dcg

    def getIdealDCG(self, sorted_labels: Sequence[float]) -> float:
        return self.getDCG(sorted(sorted_labels, reverse=True))


class DCGScorer(PrecisionScorer):
    def score(self, sorted_labels: Sequence[float]) -> float:
        return self.getDCG(sorted_labels)

    def getDCG(self, sorted_labels: Sequence[float]) -> float:
        part = [
            (math.pow(2, rel) - 1) / math.log(index + 1, 2)
            for index, rel in enumerate(sorted_labels[: self.k], 1)
        ]
        return 0.01757 * sum(part)

    def getIdealDCG(self, sorted_labels: Sequence[float]) -> float:
        return self.getDCG(sorted(sorted_labels, reverse=True))


_SCORERS = {
    "P": PrecisionScorer,
    "AP": APScorer,
    "RR": RRScorer,
    "NDCG": NDCGScorer,
    "DCG": DCGScorer,
}


def getScorer(name: str) -> MetricScorer:
    elems = name.split("@")
    k = int(elems[1]) if len(elems) == 2 else 0
    return _SCORERS[elems[0]](k)
