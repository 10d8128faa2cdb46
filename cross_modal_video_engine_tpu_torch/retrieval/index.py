"""Embedding index with exact top-k retrieval on one device.

Counterpart of cross_modal_video_engine_tpu/retrieval/index.py on a single
device: the (capacity, d) matrix of L2-normalized rows lives on the
device, allocated at a capacity (default 2x the build size) with a
validity mask, so `add` writes rows in place, `remove` tombstones them in
the mask and `compact` rebuilds without them.  Queries are L2-normalized,
rounded to the stored dtype and scored with fp32 accumulation; dead rows
score -inf and k is capped at the number of live rows, so neither padding
nor tombstones are ever returned.  `torch.topk` is exact, as the JAX
index's top-k is at its default recall_target=1.0.

Not ported yet: int8 row storage and sharding the rows over a mesh.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch


def _l2n(x: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(x, axis=1, keepdims=True)
    return x / np.maximum(n, 1e-12)


def _normalize_queries(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp_min(torch.linalg.norm(q, dim=1, keepdim=True),
                               1e-12)


def _topk(emb: torch.Tensor, valid: torch.Tensor, q: torch.Tensor,
          k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vals, idx) of the k best live rows for L2-normalized fp32
    queries q: (Q, d)."""
    sims = q.to(emb.dtype).float() @ emb.float().t()
    sims = sims.masked_fill(~valid[None, :], float("-inf"))
    return torch.topk(sims, k, dim=1)


class RetrievalIndex:
    """Normalized-embedding retrieval index on one device.

    ``dtype`` sets the stored-row precision: float32 or bfloat16 (half the
    memory traffic of float32)."""

    def __init__(self, embeddings: np.ndarray, ids: Optional[list] = None,
                 device="cpu", normalize: bool = True,
                 dtype: torch.dtype = torch.float32,
                 capacity: Optional[int] = None):
        if dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"index rows are float32 or bfloat16, not {dtype}")
        emb = np.asarray(embeddings, dtype=np.float32)
        if normalize:
            emb = _l2n(emb)
        self.dim = emb.shape[1]
        self.ids = list(ids) if ids is not None else None
        self.device = torch.device(device)
        self.dtype = dtype
        self.normalize = normalize
        self._place(emb, capacity)

    # -- placement ----------------------------------------------------------
    def _place(self, emb: np.ndarray, capacity: Optional[int]) -> None:
        n = emb.shape[0]
        cap = max(capacity or 2 * n, n, 1)
        self.emb = torch.zeros((cap, self.dim), dtype=self.dtype,
                               device=self.device)
        self.emb[:n] = torch.from_numpy(emb).to(self.device, self.dtype)
        self.valid = torch.zeros(cap, dtype=torch.bool, device=self.device)
        self.valid[:n] = True
        self.n = n                                 # slots used (tail watermark)
        self.n_active = n                          # live (non-tombstoned) rows
        self.capacity = cap

    def _rows(self) -> np.ndarray:
        """The used rows as fp32 on the host."""
        return self.emb[: self.n].float().cpu().numpy()

    # -- search ---------------------------------------------------------------
    def search(self, queries, k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        """Return (scores, indices): top-k cosine scores per query row."""
        k = min(k, self.n_active)     # never return padding/tombstones
        q = torch.as_tensor(np.asarray(queries, np.float32),
                            device=self.device)
        vals, idx = _topk(self.emb, self.valid, _normalize_queries(q), k)
        return vals.cpu().numpy(), idx.cpu().numpy()

    def search_ids(self, queries, k: int = 10):
        vals, idx = self.search(queries, k)
        if self.ids is None:
            raise ValueError("index built without ids")
        return vals, [[self.ids[j] for j in row] for row in idx]

    def searcher(self) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
        """The (emb, valid, queries, k) -> (vals, idx) search on device
        tensors, for callers that keep the query embedding on the device
        (a serving wave: text tower, then search, then one fetch).
        Queries must be L2-normalized fp32 rows; cap k with
        min(k, n_active), as `search` does."""
        return _topk

    # -- incremental updates (serving path) ----------------------------------
    def add(self, embeddings: np.ndarray, ids: Optional[list] = None,
            normalize: Optional[bool] = None) -> None:
        """Append rows in place; growth past capacity doubles and
        re-places.  normalize defaults to the index's own setting."""
        new = np.asarray(embeddings, np.float32)
        if self.normalize if normalize is None else normalize:
            new = _l2n(new)
        m = new.shape[0]
        if self.ids is not None and (ids is None or len(ids) != m):
            raise ValueError("an index with ids needs one id per added row")
        if self.n + m > self.capacity:
            tomb = ~self.valid[: self.n].cpu().numpy()
            old_n = self.n
            mat = np.concatenate([self._rows(), new], 0)
            self._place(mat, max(2 * self.capacity, mat.shape[0]))
            if tomb.any():                 # tombstones survive the growth
                self.valid[torch.from_numpy(np.nonzero(tomb)[0])] = False
                self.n_active = old_n - int(tomb.sum()) + m
        else:
            self.emb[self.n:self.n + m] = torch.from_numpy(new).to(
                self.device, self.dtype)
            self.valid[self.n:self.n + m] = True
            self.n += m
            self.n_active += m
        if self.ids is not None:
            self.ids = list(self.ids) + list(ids)

    def remove(self, row_indices: Sequence[int]) -> None:
        """Tombstone rows in place; they can never be returned.  Call
        `compact` to reclaim the slots."""
        idx = np.unique(np.asarray(list(row_indices), np.int64))
        if idx.size and (idx.min() < 0 or idx.max() >= self.n):
            raise IndexError(f"rows must lie in [0, {self.n})")
        t = torch.from_numpy(idx).to(self.device)
        self.n_active -= int(self.valid[t].sum())
        self.valid[t] = False
        if self.ids is not None:
            for i in idx:
                self.ids[int(i)] = None

    def compact(self) -> None:
        """Rebuild without tombstones, keeping the capacity."""
        live = self.valid[: self.n].cpu().numpy()
        if self.ids is not None:
            self.ids = [i for i, v in zip(self.ids, live) if v]
        self._place(self._rows()[live], self.capacity)

    def full_errors(self, queries) -> np.ndarray:
        """Dense (Q, N) error matrix (-cosine); tombstoned rows score
        +inf."""
        q = _normalize_queries(torch.as_tensor(
            np.asarray(queries, np.float32), device=self.device))
        e = -(q @ self.emb[: self.n].float().t())
        return e.masked_fill(~self.valid[None, : self.n],
                             float("inf")).cpu().numpy()

