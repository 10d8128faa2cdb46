"""Per-concept linear probing on layer embeddings.

A copy of cross_modal_video_engine_tpu/explain/probing.py (numpy) whose
probe and score need no scikit-learn, which the card's machine lacks:

* `fit_logistic` is scikit-learn's `LogisticRegression(max_iter=1000)`
  fit: the L2-penalized (C = 1) log loss with an unpenalized intercept,
  mean over the samples plus 0.5 / (C n) ||w||², minimized from zero by
  `scipy.optimize.minimize(method="L-BFGS-B")` with scikit-learn's
  options (maxls 50, gtol = tol = 1e-4, ftol = 64 eps), in float64;
* `roc_auc` is `roc_auc_score` for binary labels: the Mann-Whitney
  statistic over midranks, so tied scores count one half.

Rebuild of MCT/tools/ctvs/ctv_analysis/perception/probing.py:46-162: a
binary linear classifier per concept over frozen layer embeddings,
scored with ROC-AUC.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def fit_logistic(x: np.ndarray, y: np.ndarray, c: float = 1.0,
                 max_iter: int = 1000, tol: float = 1e-4
                 ) -> Tuple[np.ndarray, float]:
    """(coef (D,), intercept) of the binary logistic regression of y (two
    classes; the larger is the positive one) on x (N, D)."""
    from scipy.optimize import minimize
    from scipy.special import expit

    x = np.asarray(x, np.float64)
    classes = np.unique(y)
    target = (np.asarray(y) == classes[-1]).astype(np.float64)
    n, d = x.shape
    l2 = 1.0 / (c * n)

    def loss_grad(w):
        coef, raw = w[:d], x @ w[:d] + w[d]
        loss = np.logaddexp(0.0, raw) - target * raw
        g = expit(raw) - target
        grad = np.empty(d + 1)
        grad[:d] = x.T @ g / n + l2 * coef
        grad[d] = g.mean()
        return loss.mean() + 0.5 * l2 * (coef @ coef), grad

    res = minimize(loss_grad, np.zeros(d + 1), method="L-BFGS-B", jac=True,
                   options={"maxiter": max_iter, "maxls": 50, "gtol": tol,
                            "ftol": 64 * np.finfo(float).eps})
    return res.x[:d], float(res.x[d])


def roc_auc(y: np.ndarray, score: np.ndarray) -> float:
    """The area under the ROC curve of binary labels y (the larger value
    positive) and scores, ties averaged."""
    from scipy.stats import rankdata

    y = np.asarray(y)
    pos = y == np.unique(y)[-1]
    ranks = rankdata(np.asarray(score, np.float64))    # midranks
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def linear_probe_concepts(embeddings: np.ndarray,
                          concept_labels: Dict[str, np.ndarray],
                          test_fraction: float = 0.3,
                          seed: int = 0) -> Dict[str, float]:
    """embeddings: (N, D); concept_labels: concept -> (N,) binary.
    Returns concept -> test ROC-AUC of a logistic probe."""
    from scipy.special import expit

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
        coef, intercept = fit_logistic(embeddings[train_idx], y[train_idx])
        prob = expit(np.asarray(embeddings[test_idx], np.float64) @ coef
                     + intercept)
        out[concept] = roc_auc(y[test_idx], prob)
    return out
