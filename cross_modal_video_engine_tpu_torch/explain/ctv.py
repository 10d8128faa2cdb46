"""Concept-level TimeSformer Vectors (CTV): construction, scoring, stats.

A copy of cross_modal_video_engine_tpu/explain/ctv.py (numpy; sklearn is
imported inside `cluster_concept_vectors`), the MCT ctvs toolchain
(tools/ctvs/):

* instance CTVs: CTV_concept = embed(raw video) - embed(concept-masked
  video) (ctv_construction/instance_level_ctv.py:126-216 +
  inference_demo.py:138-146);
* symbolic level: per-concept mean of instance CTVs
  (ctv_analysis/concept_score.py:49-80 'mean');
* cluster level: k-means cluster centers over instance CTVs
  (concept_score.py:49-80 'cluster', sklearn);
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


def cluster_concept_vectors(instance_ctvs: Dict[str, List[np.ndarray]],
                            n_clusters: int = 3, seed: int = 0
                            ) -> Tuple[np.ndarray, List[str]]:
    """K-means centers per concept -> (n_concepts*k', D); k' adapts to the
    instance count like the reference sklearn clustering path."""
    from sklearn.cluster import KMeans

    mats, names = [], []
    for n in sorted(instance_ctvs):
        inst = np.stack(instance_ctvs[n])
        k = min(n_clusters, len(inst))
        if k <= 1:
            centers = inst.mean(axis=0, keepdims=True)
        else:
            km = KMeans(n_clusters=k, random_state=seed, n_init=10).fit(inst)
            centers = km.cluster_centers_
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
