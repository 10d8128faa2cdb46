"""Concept-level TimeSformer Vectors (CTV): construction, scoring, stats.

A copy of cross_modal_video_engine_tpu/explain/ctv.py in numpy, the MCT
ctvs toolchain (tools/ctvs/).  The JAX package clusters with
scikit-learn's KMeans; the card's machine has no scikit-learn, so
`kmeans` below is a numpy copy of what `KMeans(n_clusters=k,
random_state=seed, n_init=10).fit` computes (scikit-learn 1.9):

* instance CTVs: CTV_concept = embed(raw video) - embed(concept-masked
  video) (ctv_construction/instance_level_ctv.py:126-216 +
  inference_demo.py:138-146);
* symbolic level: per-concept mean of instance CTVs
  (ctv_analysis/concept_score.py:49-80 'mean');
* cluster level: k-means cluster centers over instance CTVs
  (concept_score.py:49-80 'cluster');
* concept score: concept_matrix @ grad (concept_score.py:191-193,
  inference_demo.py:280);
* TCAV statistics: per-class mean of normalized concept scores
  (tcav_statistic.py:115-170);
* robustness: cosine consistency of a concept's instance CTVs
  (concept_vec_robustness.py).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


def build_instance_ctvs(embed_fn: Callable[[np.ndarray], np.ndarray],
                        raw_video: np.ndarray,
                        masked_videos: Dict[str, np.ndarray]
                        ) -> Dict[str, np.ndarray]:
    """embed_fn maps a (T, H, W, 3) clip -> (D,) embedding (the hooked
    layer's CLS feature).  Batches raw + all masked clips into ONE device
    call — the reference runs N_concepts+1 sequential model passes
    (inference_demo.py:138-146)."""
    names = list(masked_videos)
    stack = np.stack([raw_video] + [masked_videos[n] for n in names])
    embs = np.asarray(embed_fn(stack))
    raw = embs[0]
    return {n: raw - embs[i + 1] for i, n in enumerate(names)}


def symbolic_concept_vectors(instance_ctvs: Dict[str, List[np.ndarray]]
                             ) -> Tuple[np.ndarray, List[str]]:
    """Per-concept mean over instances -> (n_concepts, D) matrix."""
    names = sorted(instance_ctvs)
    mat = np.stack([np.mean(np.stack(instance_ctvs[n]), axis=0)
                    for n in names])
    return mat.astype(np.float32), names


def _sq_distances(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """scikit-learn's `_euclidean_distances(a, b, squared=True)`: float32
    rows are upcast to float64, the result stored in the rows' dtype."""
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    d = -2 * (a64 @ b64.T)
    d += np.einsum("ij,ij->i", a64, a64)[:, None]
    d += np.einsum("ij,ij->i", b64, b64)[None, :]
    return np.maximum(d.astype(a.dtype, copy=False), 0)


def _kmeans_plusplus(x: np.ndarray, k: int,
                     rs: np.random.RandomState) -> np.ndarray:
    """Greedy k-means++ (`_kmeans_plusplus`): the first centre drawn by
    `choice`, then 2 + int(log k) candidates a centre, drawn by `uniform`
    against the cumulative potential; the one that lowers it most wins."""
    n = len(x)
    w = np.ones(n, x.dtype)
    trials = 2 + int(np.log(k))
    centers = np.empty((k, x.shape[1]), x.dtype)
    first = rs.choice(n, p=w / w.sum())
    centers[0] = x[first]
    closest = _sq_distances(x[first][None], x)
    pot = closest @ w
    for c in range(1, k):
        vals = rs.uniform(size=trials) * pot
        ids = np.searchsorted(np.cumsum(w * closest), vals)
        np.clip(ids, None, closest.size - 1, out=ids)
        dist = np.minimum(closest, _sq_distances(x[ids], x))
        pots = dist @ w.reshape(-1, 1)
        best = int(np.argmin(pots))
        pot, closest = pots[best], dist[best]
        centers[c] = x[ids[best]]
    return centers


def _lloyd_step(x: np.ndarray, centers: np.ndarray, update: bool = True):
    """One iteration of `lloyd_iter_chunked_dense`: labels by the first
    smallest |c|^2 - 2 x.c, then the new centres (empty clusters taken by
    the farthest points, as `_relocate_empty_clusters_dense` does) and
    each centre's shift."""
    d = np.einsum("ij,ij->i", centers, centers)[None, :] - 2 * (x @ centers.T)
    labels = np.argmin(d, axis=1).astype(np.int32)
    if not update:
        return labels, None, None
    k = len(centers)
    new = np.zeros_like(centers)
    np.add.at(new, labels, x)
    weight = np.bincount(labels, minlength=k).astype(x.dtype)
    empty = np.flatnonzero(weight == 0)
    if len(empty):
        dist = ((x - centers[labels]) ** 2).sum(axis=1)
        if dist.max() != 0:
            far = np.argpartition(dist, -len(empty))[:-len(empty) - 1:-1]
            for cid, idx in zip(empty, far):
                new[labels[idx]] -= x[idx]
                new[cid] = x[idx]
                weight[cid] = 1
                weight[labels[idx]] -= 1
    big = int(np.argmax(weight))
    for j in range(k):
        if weight[j] > 0:
            new[j] *= x.dtype.type(1.0) / weight[j]
        else:
            new[j] = new[big]
    shift = np.sqrt(((new - centers) ** 2).sum(axis=1))
    return labels, new, shift


def _same_clustering(a: np.ndarray, b: np.ndarray, k: int) -> bool:
    mapping = np.full(k, -1)
    for i, j in zip(a, b):
        if mapping[i] == -1:
            mapping[i] = j
        elif mapping[i] != j:
            return False
    return True


def kmeans(x: np.ndarray, k: int, seed: int = 0, n_init: int = 10,
           max_iter: int = 300, tol: float = 1e-4
           ) -> Tuple[np.ndarray, np.ndarray, float]:
    """(centres (k, D), labels (N,), inertia) as `KMeans(n_clusters=k,
    random_state=seed, n_init=n_init, max_iter=max_iter, tol=tol).fit(x)`
    gives them: one RandomState carried across the inits, Lloyd's
    iterations on the centred data until the labels repeat or the
    centres' squared shift is within tol times the mean per-feature
    variance, the init of the lowest inertia kept.  x keeps its dtype
    (float32 or float64)."""
    x = np.array(x, dtype=x.dtype if x.dtype in (np.float32, np.float64)
                 else np.float64, order="C", copy=True)
    if len(x) < k:
        raise ValueError(f"n_samples={len(x)} should be >= n_clusters={k}.")
    rs = np.random.RandomState(seed)
    tol_x = float(np.mean(np.var(x, axis=0)) * tol)
    mean = x.mean(axis=0)
    x -= mean
    best = None
    for _ in range(n_init):
        centers = _kmeans_plusplus(x, k, rs)
        labels_old = np.full(len(x), -1, np.int32)
        strict = False
        for _ in range(max_iter):
            labels, new, shift = _lloyd_step(x, centers)
            centers = new
            if np.array_equal(labels, labels_old):
                strict = True
                break
            if (shift ** 2).sum() <= tol_x:
                break
            labels_old = labels
        if not strict:
            labels = _lloyd_step(x, centers, update=False)[0]
        # summed in x's dtype, one sample after another, as `_inertia_dense`
        inertia = float(np.cumsum(((x - centers[labels]) ** 2).sum(axis=1))[-1])
        if best is None or (inertia < best[2] and not _same_clustering(
                labels, best[1], k)):
            best = (centers, labels, inertia)
    centers, labels, inertia = best
    return centers + mean, labels, inertia


def cluster_concept_vectors(instance_ctvs: Dict[str, List[np.ndarray]],
                            n_clusters: int = 3, seed: int = 0
                            ) -> Tuple[np.ndarray, List[str]]:
    """K-means centers per concept -> (n_concepts*k', D); k' adapts to the
    instance count like the reference sklearn clustering path."""
    mats, names = [], []
    for n in sorted(instance_ctvs):
        inst = np.stack(instance_ctvs[n])
        k = min(n_clusters, len(inst))
        if k <= 1:
            centers = inst.mean(axis=0, keepdims=True)
        else:
            centers = kmeans(inst, k, seed)[0]
        for j, c in enumerate(centers):
            mats.append(c)
            names.append(f"{n}#c{j}")
    return np.stack(mats).astype(np.float32), names


def concept_scores(concept_matrix: np.ndarray, grad: np.ndarray
                   ) -> np.ndarray:
    """(n_concepts, D) @ (D,) -> (n_concepts,) directional derivatives."""
    return concept_matrix @ grad


def top_concepts(scores: np.ndarray, names: Sequence[str], k: int = 5
                 ) -> List[Tuple[str, float]]:
    order = np.argsort(-scores)[:k]
    return [(names[i], float(scores[i])) for i in order]


def tcav_statistics(per_video_scores: Dict[str, List[np.ndarray]],
                    concept_names: Sequence[str]) -> Dict[str, Dict[str, float]]:
    """per_video_scores: class_name -> list of per-video score vectors.
    Returns class -> {concept: mean normalized score}
    (tcav_statistic.py:115-170: scores L1-normalized per video, then
    averaged per class)."""
    out = {}
    for cls, score_list in per_video_scores.items():
        acc = np.zeros(len(concept_names), np.float64)
        for s in score_list:
            denom = np.sum(np.abs(s))
            acc += s / denom if denom > 0 else s
        mean = acc / max(len(score_list), 1)
        out[cls] = {n: float(v) for n, v in zip(concept_names, mean)}
    return out


def concept_robustness(instance_ctvs: Dict[str, List[np.ndarray]]
                       ) -> Dict[str, float]:
    """Mean pairwise cosine similarity of a concept's instance CTVs —
    high = the concept direction is stable across videos."""
    out = {}
    for n, vecs in instance_ctvs.items():
        if len(vecs) < 2:
            out[n] = 1.0
            continue
        m = np.stack(vecs)
        m = m / np.maximum(np.linalg.norm(m, axis=1, keepdims=True), 1e-12)
        sim = m @ m.T
        iu = np.triu_indices(len(m), k=1)
        out[n] = float(sim[iu].mean())
    return out
