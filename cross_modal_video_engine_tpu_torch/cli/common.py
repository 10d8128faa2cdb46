"""Shared CLI plumbing: dataset-layout resolution and model (re)construction.

Counterpart of cross_modal_video_engine_tpu/cli/common.py.  Dataset
directory layout mirrors the reference rootpath convention
(LINAS-engine/trainer.py:114-136):

  <rootpath>/<collection>/FeatureData/<feature>/            BigFile dir
  <rootpath>/<collection>/FeatureData/<feature>/video2frames.txt
  <rootpath>/<collection>/TextData/<collection>.caption.txt
  <rootpath>/<collection>/TextData/vocabulary/rnn/word_vocab_5.json
  <rootpath>/<collection>/TextData/vocabulary/bow/word_vocab_5.json
"""

from __future__ import annotations

import os
from typing import Tuple

from ..convert.from_jax import dual_encoding_state_dict_from_jax
from ..data.provider import LinasDataset, read_video2frames
from ..io.bigfile import BigFile
from ..models.dual_encoding import DualEncoding, DualEncodingConfig
from ..train.checkpoint import load_checkpoint
from ..utils.precision import no_tf32
from ..utils.text2vec import Bow2Vec
from ..utils.vocab import Vocabulary


def collection_paths(rootpath: str, collection: str, feature: str,
                     vocab_name: str = "word_vocab_5"):
    base = os.path.join(rootpath, collection)
    return dict(
        feat_dir=os.path.join(base, "FeatureData", feature),
        video2frames=os.path.join(base, "FeatureData", feature,
                                  "video2frames.txt"),
        cap_file=os.path.join(base, "TextData", f"{collection}.caption.txt"),
        rnn_vocab=os.path.join(base, "TextData", "vocabulary", "rnn",
                               f"{vocab_name}.json"),
        bow_vocab=os.path.join(base, "TextData", "vocabulary", "bow",
                               f"{vocab_name}.json"),
    )


def load_dataset(rootpath: str, collection: str, feature: str,
                 vocab_name: str = "word_vocab_5",
                 support_set_number: int = 8,
                 max_words: int = 32, device=None) -> LinasDataset:
    """The collection's dataset; its batches go to `device` (None: the
    CUDA device)."""
    p = collection_paths(rootpath, collection, feature, vocab_name)
    visual_feat = BigFile(p["feat_dir"])
    video2frames = read_video2frames(p["video2frames"])
    rnn_vocab = Vocabulary.load(p["rnn_vocab"])
    bow_vocab = Vocabulary.load(p["bow_vocab"])
    bow2vec = Bow2Vec(bow_vocab)
    return LinasDataset(
        p["cap_file"], visual_feat, video2frames, bow2vec, rnn_vocab,
        support_set_number=support_set_number, max_words=max_words,
        device=device)


def restore_dual_encoding(checkpoint: str, device=None
                          ) -> Tuple[DualEncoding, dict]:
    """Rebuild the model from the config embedded in the checkpoint (the
    reference stores the full argparse `opt` in the .pth.tar,
    trainer.py:288-295) and load its weights, on `device` (None: the CUDA
    device), in eval mode.  Returns (model, {"config", "meta"}).  The
    model computes in f32 as the JAX package does: TF32 is turned off
    for the process (cuDNN's convolutions and GRU default to it)."""
    no_tf32()
    variables, config, meta = load_checkpoint(checkpoint)
    cfg_kwargs = dict(config)
    for key in ("visual_kernel_sizes", "text_kernel_sizes"):
        if key in cfg_kwargs:
            cfg_kwargs[key] = tuple(cfg_kwargs[key])
    cfg = DualEncodingConfig(**cfg_kwargs)
    model = DualEncoding(cfg, device=device)
    model.load_state_dict(dual_encoding_state_dict_from_jax(variables, cfg))
    return model, {"config": cfg, "meta": meta}
