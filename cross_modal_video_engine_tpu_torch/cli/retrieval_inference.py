"""Single-query text->video retrieval CLI.

Counterpart of cross_modal_video_engine_tpu/cli/retrieval_inference.py and
parity surface for LINAS-engine/inference.py:46-82:
  * loads the checkpoint (config embedded; the JAX package's format) and
    rebuilds the model on the device;
  * builds/caches the full video-embedding index (the reference caches to
    `video_data.pt`, inference.py:57-67; both packages cache
    `video_index.npz` in one format, so either reads the other's cache);
  * embeds the query through the student text path (embed_txt_distill,
    inference.py:77);
  * prints the top-K video ids.

Usage:
  python -m cross_modal_video_engine_tpu_torch.cli.retrieval_inference \
      --checkpoint CKPT_DIR --rootpath ROOT --collection C \
      --visual_feature F --input "a man riding a horse" --topK 10 \
      [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data.provider import LinasDataset
from ..models.dual_encoding import DualEncoding, make_text_batch
from ..retrieval.index import RetrievalIndex
from .common import load_dataset, restore_dual_encoding

INDEX_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int8": torch.int8}


def build_video_index(model: DualEncoding, dataset: LinasDataset,
                      batch_size: int = 64, cache: str | None = None,
                      dtype=None, capacity: int | None = None
                      ) -> RetrievalIndex:
    """The collection's videos through `embed_vis_distill`, a batch at a
    time, into an index on the model's device.  dtype: stored-row
    precision (a torch dtype or its name; float32 default, bfloat16/int8
    are the serving configurations, see RetrievalIndex).  capacity: index
    slot count (default 2x rows for incremental add headroom; pass the row
    count for a frozen corpus to halve the index's memory).  cache: an
    .npz of the embeddings and ids, read if it exists, else written."""
    dtype = INDEX_DTYPES.get(dtype, dtype) if dtype else torch.float32
    if cache and os.path.exists(cache):
        data = np.load(cache, allow_pickle=True)
        return RetrievalIndex(data["emb"], ids=[str(i) for i in data["ids"]],
                              device=model.device, dtype=dtype,
                              capacity=capacity)
    chunks = []
    with torch.no_grad():
        for batch, n in dataset.video_batches(batch_size):
            chunks.append(model.embed_vis_distill(batch)[:n])
    emb = torch.cat(chunks, 0)
    names = dataset.video_ids
    if cache:
        np.savez(cache, emb=emb.cpu().numpy(), ids=np.array(names))
    return RetrievalIndex(emb, ids=names, device=model.device, dtype=dtype,
                          capacity=capacity)


def embed_query(model: DualEncoding, dataset: LinasDataset,
                query: str) -> np.ndarray:
    """(1, common_dim) student embedding of one query, on the host."""
    bow, ids = dataset.process_cap(query)
    batch = make_text_batch([ids[: dataset.max_words]], bow[None, :],
                            dataset.max_words, device=model.device)
    with torch.no_grad():
        return model.embed_txt_distill(batch).cpu().numpy()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--rootpath", required=True)
    parser.add_argument("--collection", required=True)
    parser.add_argument("--visual_feature", required=True)
    parser.add_argument("--input", required=True, help="text query")
    parser.add_argument("--topK", type=int, default=10)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--index_cache", default=None,
                        help="npz cache of the video index")
    parser.add_argument("--device", default=None,
                        help="default: the CUDA device")
    args = parser.parse_args(argv)

    model, _ = restore_dual_encoding(args.checkpoint, device=args.device)
    dataset = load_dataset(args.rootpath, args.collection,
                           args.visual_feature, device=model.device)
    index = build_video_index(model, dataset, args.batch_size,
                              args.index_cache)
    q = embed_query(model, dataset, args.input)
    scores, id_rows = index.search_ids(q, k=args.topK)
    for vid, score in zip(id_rows[0], scores[0]):
        print(f"{vid}\t{score:.4f}")
    return id_rows[0]


if __name__ == "__main__":
    main()
