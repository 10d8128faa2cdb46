"""Embedding index with exact top-k retrieval on one device.

Counterpart of cross_modal_video_engine_tpu/retrieval/index.py on a single
device: the (capacity, d) matrix of L2-normalized rows lives on the
device, allocated at a capacity (default 2x the build size) with a
validity mask, so `add` writes rows in place, `remove` tombstones them in
the mask and `compact` rebuilds without them.  Dead rows score -inf and k
is capped at the number of live rows, so neither padding nor tombstones
are ever returned.  `torch.topk` is exact, as the JAX index's top-k is at
its default recall_target=1.0.

Rows are stored as float32, bfloat16 or int8:

* float32 / bfloat16: queries are L2-normalized, rounded to the stored
  dtype and scored against the rows as they are stored, with fp32
  accumulation and an fp32 result.  No fp32 copy of the rows is made: on
  the card one matrix product reads the stored rows; on the CPU the rows
  are scored a chunk at a time.
* int8: symmetric quantization with a per-row scale (amax / 127, 4 bytes
  a row; unit-norm rows have components near 1/sqrt(d), so one global
  scale would waste most of the int8 range).  The query is quantized per
  row on the device, the int8 x int8 product accumulates in int32
  (`torch._int_mm` on the card), and the scores are rescaled by
  query scale x row scale to approximate the cosine.  Quantization can
  reorder near-ties; the bench rows report recall@k against the exact
  answer.

The JAX index computes these products outside any Pallas kernel, so they
are torch matrix products here.  Not ported yet: sharding the rows over
several devices.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device

_DTYPES = (torch.float32, torch.bfloat16, torch.int8)
# rows scored at a time where the rows have to be widened (CPU; dense
# errors): the temporary stays this many rows, whatever the index holds
_CHUNK_ROWS = 65536
# torch._int_mm on the card: more than 16 rows, every size a multiple of 8
_INT_MM_MIN_ROWS = 32


def _l2n(x: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(x, axis=1, keepdims=True)
    return x / np.maximum(n, 1e-12)


def _normalize_queries(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp_min(torch.linalg.norm(q, dim=1, keepdim=True),
                               1e-12)


def _encode(rows: torch.Tensor, dtype: torch.dtype
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 rows -> (stored rows, fp32 per-row scales; ones unless int8)."""
    if dtype == torch.int8:
        amax = torch.clamp_min(rows.abs().amax(dim=1), 1e-12)
        scales = amax / 127.0
        stored = torch.clamp(torch.round(rows / scales[:, None]),
                             -127, 127).to(torch.int8)
        return stored, scales
    return rows.to(dtype), torch.ones(rows.shape[0], dtype=torch.float32,
                                      device=rows.device)


def _decode(stored: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Stored rows widened to fp32 (int8 rows times their scales)."""
    x = stored.float()
    return x * scales[:, None] if stored.dtype == torch.int8 else x


def _quantize_queries(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (Q, d) -> int8 (Q, d) and the (Q, 1) fp32 scales."""
    amax = torch.clamp_min(q.abs().amax(dim=1, keepdim=True), 1e-12)
    qq = torch.clamp(torch.round(q / amax * 127.0), -127, 127).to(torch.int8)
    return qq, amax / 127.0


def _int8_scores(emb: torch.Tensor, qq: torch.Tensor) -> torch.Tensor:
    """int8 (Q, d) x int8 (rows, d)^T -> int32 (Q, rows)."""
    if emb.device.type != "cuda":
        return torch.cat([qq.int() @ c.int().t()
                          for c in emb.split(_CHUNK_ROWS)], 1)
    nq, d = qq.shape
    if d % 8 or emb.shape[0] % 8:
        raise ValueError(f"int8 scoring on the card needs the width and the "
                         f"capacity in multiples of 8, got {d} and "
                         f"{emb.shape[0]}")
    pad = max(_INT_MM_MIN_ROWS, -(-nq // 8) * 8) - nq
    if pad:
        qq = torch.cat([qq, qq.new_zeros((pad, d))])
    return torch._int_mm(qq, emb.t())[:nq]


def _scores(emb: torch.Tensor, scales: torch.Tensor,
            q: torch.Tensor) -> torch.Tensor:
    """fp32 (Q, rows) scores of L2-normalized fp32 queries against the
    rows as stored, without an fp32 copy of them."""
    if emb.dtype == torch.int8:
        qq, qscale = _quantize_queries(q)
        return _int8_scores(emb, qq).float() * qscale * scales[None, :]
    if emb.dtype == torch.float32:
        return q @ emb.t()
    qd = q.to(emb.dtype)
    if emb.device.type == "cuda":    # fp32 accumulation, fp32 result
        return torch.mm(qd, emb.t(), out_dtype=torch.float32)
    return torch.cat([qd.float() @ c.float().t()
                      for c in emb.split(_CHUNK_ROWS)], 1)


def _topk(emb: torch.Tensor, scales: torch.Tensor, valid: torch.Tensor,
          q: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vals, idx) of the k best live rows for L2-normalized fp32
    queries q: (Q, d)."""
    sims = _scores(emb, scales, q).masked_fill_(~valid[None, :],
                                                float("-inf"))
    return torch.topk(sims, k, dim=1)


class RetrievalIndex:
    """Normalized-embedding retrieval index on one device.

    ``dtype`` sets the stored-row precision: float32, bfloat16 (half the
    memory traffic) or int8 (half again, per-row scales).  ``device=None``
    is the CUDA device.  ``embeddings`` (and the rows given to `add`) are
    a numpy array or a torch tensor; a tensor already on the device is
    normalized and encoded there."""

    def __init__(self, embeddings, ids: Optional[list] = None,
                 device=None, normalize: bool = True,
                 dtype: torch.dtype = torch.float32,
                 capacity: Optional[int] = None):
        if dtype not in _DTYPES:
            raise TypeError(f"index rows are float32, bfloat16 or int8, not "
                            f"{dtype}")
        self.device = resolve_device(device)
        self.dtype = dtype
        self.int8 = dtype == torch.int8
        self.normalize = normalize
        emb = self._rows_in(embeddings, normalize)
        self.dim = emb.shape[1]
        self.ids = list(ids) if ids is not None else None
        self._place(emb, capacity)

    # -- placement ----------------------------------------------------------
    def _rows_in(self, rows, normalize: bool) -> torch.Tensor:
        """Caller's rows as fp32 on the device, normalized if asked: numpy
        rows on the host with numpy (as the JAX index does), tensors where
        they are."""
        if isinstance(rows, torch.Tensor):
            rows = rows.to(self.device, torch.float32)
            return _normalize_queries(rows) if normalize else rows
        rows = np.asarray(rows, dtype=np.float32)
        if normalize:
            rows = _l2n(rows)
        return torch.from_numpy(np.ascontiguousarray(rows))

    def _place(self, emb: torch.Tensor, capacity: Optional[int]) -> None:
        n = emb.shape[0]
        cap = max(capacity or 2 * n, n, 1)
        if self.int8:
            cap += (-cap) % 8                      # torch._int_mm's sizes
        stored, scales = _encode(emb, self.dtype)
        self.emb = torch.zeros((cap, self.dim), dtype=self.dtype,
                               device=self.device)
        self.emb[:n] = stored.to(self.device)
        self.scales = torch.ones(cap, dtype=torch.float32,
                                 device=self.device)
        self.scales[:n] = scales.to(self.device)
        self.valid = torch.zeros(cap, dtype=torch.bool, device=self.device)
        self.valid[:n] = True
        self.n = n                                 # slots used (tail watermark)
        self.n_active = n                          # live (non-tombstoned) rows
        self.capacity = cap

    def _rows(self) -> torch.Tensor:
        """The used rows decoded to fp32, on the host."""
        return _decode(self.emb[: self.n].cpu(), self.scales[: self.n].cpu())

    # -- search ---------------------------------------------------------------
    def search(self, queries, k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        """Return (scores, indices): top-k cosine scores per query row."""
        k = min(k, self.n_active)     # never return padding/tombstones
        q = torch.as_tensor(np.asarray(queries, np.float32),
                            device=self.device)
        vals, idx = _topk(self.emb, self.scales, self.valid,
                          _normalize_queries(q), k)
        return vals.cpu().numpy(), idx.cpu().numpy()

    def search_ids(self, queries, k: int = 10):
        vals, idx = self.search(queries, k)
        if self.ids is None:
            raise ValueError("index built without ids")
        return vals, [[self.ids[j] for j in row] for row in idx]

    def searcher(self) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
        """The (emb, scales, valid, queries, k) -> (vals, idx) search on
        device tensors, for callers that keep the query embedding on the
        device (a serving wave: text tower, then search, then one fetch).
        Queries must be L2-normalized fp32 rows; cap k with
        min(k, n_active), as `search` does."""
        return _topk

    # -- incremental updates (serving path) ----------------------------------
    def add(self, embeddings, ids: Optional[list] = None,
            normalize: Optional[bool] = None) -> None:
        """Append rows in place; growth past capacity doubles and
        re-places.  normalize defaults to the index's own setting."""
        new = self._rows_in(embeddings,
                            self.normalize if normalize is None else normalize)
        m = new.shape[0]
        if self.ids is not None and (ids is None or len(ids) != m):
            raise ValueError("an index with ids needs one id per added row")
        if self.n + m > self.capacity:
            tomb = ~self.valid[: self.n].cpu()
            old_n = self.n
            mat = torch.cat([self._rows(), new.cpu()], 0)
            self._place(mat, max(2 * self.capacity, mat.shape[0]))
            if tomb.any():                 # tombstones survive the growth
                self.valid[tomb.nonzero().flatten().to(self.device)] = False
                self.n_active = old_n - int(tomb.sum()) + m
        else:
            stored, scales = _encode(new, self.dtype)
            self.emb[self.n:self.n + m] = stored.to(self.device)
            self.scales[self.n:self.n + m] = scales.to(self.device)
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
        """Rebuild without tombstones, keeping the capacity (through the
        host; use sparingly)."""
        live = self.valid[: self.n].cpu()
        if self.ids is not None:
            self.ids = [i for i, v in zip(self.ids, live.tolist()) if v]
        self._place(self._rows()[live], self.capacity)

    def full_errors(self, queries) -> np.ndarray:
        """Dense (Q, N) error matrix (-cosine) of the unrounded queries
        against the decoded rows, a chunk of rows at a time; tombstoned
        rows score +inf."""
        q = _normalize_queries(torch.as_tensor(
            np.asarray(queries, np.float32), device=self.device))
        e = torch.cat([-(q @ _decode(c, s).t()) for c, s in zip(
            self.emb[: self.n].split(_CHUNK_ROWS),
            self.scales[: self.n].split(_CHUNK_ROWS))], 1)
        return e.masked_fill_(~self.valid[None, : self.n],
                              float("inf")).cpu().numpy()
