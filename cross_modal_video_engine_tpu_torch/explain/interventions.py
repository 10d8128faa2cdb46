"""Activation interventions: zero-out and temporal-shuffle probes.

Counterpart of cross_modal_video_engine_tpu/explain/interventions.py,
the MCT interpretability probes:

* `zero_out_tokens` — the core/hooks/zeroout.py equivalent: re-run the
  model from a captured layer with selected tokens zeroed and measure the
  prediction change (on a copy of the captured tokens, no hooks);
* `temporal_shuffle_contrast` — the RandomShuffleFrames +
  recognizer_shuffle.py probe: embedding/score distance between the
  original clip and temporally shuffled versions, quantifying how much
  the model uses temporal order (tools/ctvs/ctv_analysis/
  temporal_analysis/temporal_shuffle_contrast.py).  Its permutations are
  numpy's `default_rng(seed)` draws, the JAX package's.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def zero_out_tokens(model, videos: torch.Tensor, layer: int,
                    token_indices: Sequence[int]) -> Dict:
    """Zero the given token positions at `layer` and report the score
    deltas.  Returns dict(scores, scores_zeroed, delta, pred, pred_zeroed)
    as numpy.  Negative indices count from the end, as in numpy."""
    with torch.no_grad():
        scores, captured = model.forward_with_capture(videos, (layer,))
        tokens = captured[layer]
        idx = np.asarray(list(token_indices), dtype=np.int64)
        if idx.size:
            idx = torch.from_numpy(idx % tokens.shape[1]).to(tokens.device)
            zeroed = tokens.index_fill(1, idx, 0.0)    # a copy
        else:
            zeroed = tokens
        scores_z = model.score_from_layer(zeroed, layer)
    return {
        "scores": scores.cpu().numpy(),
        "scores_zeroed": scores_z.cpu().numpy(),
        "delta": (scores - scores_z).cpu().numpy(),
        "pred": scores.argmax(-1).cpu().numpy(),
        "pred_zeroed": scores_z.argmax(-1).cpu().numpy(),
    }


def temporal_shuffle_contrast(embed_fn, frames: np.ndarray,
                              n_shuffles: int = 8, seed: int = 0) -> Dict:
    """embed_fn: (N, T, H, W, 3) numpy -> (N, D) numpy or tensor.  Embeds
    the original clip and `n_shuffles` random temporal permutations in ONE
    batch; reports cosine similarity stats (low similarity = temporally
    sensitive model)."""
    rng = np.random.default_rng(seed)
    T = frames.shape[0]
    perms = [rng.permutation(T) for _ in range(n_shuffles)]
    stack = np.stack([frames] + [frames[p] for p in perms])
    embs = embed_fn(stack)
    if isinstance(embs, torch.Tensor):
        embs = embs.detach().float().cpu()
    embs = np.asarray(embs)
    ref = embs[0] / max(np.linalg.norm(embs[0]), 1e-12)
    sims = []
    for e in embs[1:]:
        sims.append(float(ref @ (e / max(np.linalg.norm(e), 1e-12))))
    sims = np.asarray(sims)
    return {
        "similarities": sims,
        "mean_similarity": float(sims.mean()),
        "temporal_sensitivity": float(1.0 - sims.mean()),
        "perms": perms,
    }
