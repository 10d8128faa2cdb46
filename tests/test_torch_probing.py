"""The port's concept probe without scikit-learn (explain/probing.py)
against scikit-learn on the CPU: `fit_logistic` against
`LogisticRegression(max_iter=1000)` (coefficients and intercept within
1e-3), `roc_auc` against `roc_auc_score` on scores with ties (within
1e-6), and `linear_probe_concepts` with scikit-learn made unimportable
against the JAX package's, which fits with scikit-learn."""

import sys

import numpy as np
import pytest

from cross_modal_video_engine_tpu.explain import probing as jprobe
from cross_modal_video_engine_tpu_torch.explain import probing as tprobe

CASES = [(60, 4, 1.0), (200, 16, 2.0), (120, 6, 3.0), (300, 32, 1.0)]


@pytest.mark.parametrize("n,d,scale", CASES)
def test_logistic_fit_matches_scikit_learn(n, d, scale):
    from sklearn.linear_model import LogisticRegression
    rng = np.random.default_rng(n + d)
    x = rng.standard_normal((n, d)) * scale
    y = ((x[:, 0] - 0.3 * x[:, 1] + 0.5 * rng.standard_normal(n)) > 0.2)
    y = np.where(y, 7, 3)                         # labels other than 0/1
    clf = LogisticRegression(max_iter=1000).fit(x, y)
    coef, intercept = tprobe.fit_logistic(x, y)
    assert np.abs(coef - clf.coef_[0]).max() <= 1e-3
    assert abs(intercept - clf.intercept_[0]) <= 1e-3


@pytest.mark.parametrize("seed", range(4))
def test_roc_auc_matches_scikit_learn(seed):
    from sklearn.metrics import roc_auc_score
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, 150)
    scores = np.round(rng.standard_normal(150) + 0.7 * y, 1)   # ties
    assert abs(tprobe.roc_auc(y, scores) - roc_auc_score(y, scores)) <= 1e-6


def test_probe_needs_no_scikit_learn(monkeypatch):
    rng = np.random.default_rng(9)
    emb = rng.standard_normal((120, 6))
    labels = {"signal": (emb[:, 0] > 0).astype(int),
              "noise": rng.integers(0, 2, 120)}
    want = jprobe.linear_probe_concepts(emb, labels, seed=2)
    for mod in [m for m in list(sys.modules) if m.split(".")[0] == "sklearn"]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    got = tprobe.linear_probe_concepts(emb, labels, seed=2)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, k
