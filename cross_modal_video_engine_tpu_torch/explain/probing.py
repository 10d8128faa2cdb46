"""Per-concept linear probing on layer embeddings.

A copy of cross_modal_video_engine_tpu/explain/probing.py (numpy; sklearn
is imported inside the function).

Rebuild of MCT/tools/ctvs/ctv_analysis/perception/probing.py:46-162: a
binary linear classifier per concept over frozen layer embeddings,
scored with ROC-AUC.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def linear_probe_concepts(embeddings: np.ndarray,
                          concept_labels: Dict[str, np.ndarray],
                          test_fraction: float = 0.3,
                          seed: int = 0) -> Dict[str, float]:
    """embeddings: (N, D); concept_labels: concept -> (N,) binary.
    Returns concept -> test ROC-AUC of a logistic probe."""
    from sklearn.linear_model import LogisticRegression
    from sklearn.metrics import roc_auc_score

    rng = np.random.default_rng(seed)
    n = embeddings.shape[0]
    perm = rng.permutation(n)
    n_test = max(1, int(n * test_fraction))
    test_idx, train_idx = perm[:n_test], perm[n_test:]
    out = {}
    for concept, y in concept_labels.items():
        y = np.asarray(y)
        if len(np.unique(y[train_idx])) < 2 or len(np.unique(y[test_idx])) < 2:
            out[concept] = float("nan")
            continue
        clf = LogisticRegression(max_iter=1000)
        clf.fit(embeddings[train_idx], y[train_idx])
        prob = clf.predict_proba(embeddings[test_idx])[:, 1]
        out[concept] = float(roc_auc_score(y[test_idx], prob))
    return out
