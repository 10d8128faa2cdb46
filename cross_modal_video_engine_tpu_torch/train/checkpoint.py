"""Checkpoints in the JAX package's directory format.

Counterpart of cross_modal_video_engine_tpu/train/checkpoint.py
(`save_checkpoint`, `load_checkpoint`): a directory with

* `config.json`: `{"meta": ..., "config": dataclass fields,
  "config_class": name}`, as the JAX package writes it;
* `params.msgpack`: the variables tree in flax's msgpack form, read and
  written by io/flax_msgpack.py, so neither msgpack nor flax is needed.

A checkpoint either package writes loads in the other: `save_checkpoint`
orders every dict's keys as `jax.tree.map` does before the JAX package
serializes, so for the same tree both write the same bytes.  Trees hold
numpy arrays or torch tensors (bfloat16 too); the loader gives CPU torch
tensors.  `best_checkpoint_manager` keeps only the best checkpoint, as the
reference trainer does (trainer.py:413-419).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..io import flax_msgpack


def _to_jsonable(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {k: _to_jsonable(v) for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, (list, tuple)):
        return list(obj)
    return obj


def _host_tree(x):
    """What the JAX package's `jax.tree.map(np.asarray, ...)` makes of a
    tree before it is written: dict keys sorted, sequences kept, leaves
    as arrays (torch tensors stay tensors: bfloat16 has no numpy dtype)."""
    if isinstance(x, dict):
        return {k: _host_tree(x[k]) for k in sorted(x)}
    if isinstance(x, (list, tuple)):
        return type(x)(_host_tree(v) for v in x)
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return np.asarray(x)


def save_checkpoint(path: str, variables: Any, config: Any = None,
                    meta: Optional[Dict] = None) -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "params.msgpack"), "wb") as f:
        f.write(flax_msgpack.to_bytes(_host_tree(variables)))
    blob = {"meta": meta or {}}
    if config is not None:
        blob["config"] = _to_jsonable(config)
        blob["config_class"] = type(config).__name__
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(blob, f, indent=1, default=str)


def load_checkpoint(path: str) -> Tuple[Any, Dict, Dict]:
    """Returns (variables, config_dict, meta): the variables tree as the
    JAX package's `load_checkpoint(path)` returns it without a template,
    with CPU torch tensors for its arrays."""
    with open(os.path.join(path, "config.json")) as f:
        blob = json.load(f)
    with open(os.path.join(path, "params.msgpack"), "rb") as f:
        data = f.read()
    return (flax_msgpack.restore(data), blob.get("config", {}),
            blob.get("meta", {}))


def best_checkpoint_manager(root: str):
    """Returns save_best(variables, config, score, meta) -> bool, which
    writes `model_best_{score:.4f}` under root when score beats the best so
    far, points the `model_best` symlink at it and deletes the old best."""
    state = {"best": -np.inf, "path": None}

    def save_best(variables, config, score, meta=None) -> bool:
        if score <= state["best"]:
            return False
        new_path = os.path.join(root, f"model_best_{score:.4f}")
        save_checkpoint(new_path, variables, config,
                        dict(meta or {}, score=float(score)))
        link = os.path.join(root, "model_best")
        if os.path.islink(link):
            os.unlink(link)
        elif os.path.exists(link):
            shutil.rmtree(link)
        os.symlink(os.path.abspath(new_path), link)
        # a new best whose score prints to the same name overwrote the
        # directory in place: deleting the "old" path would delete it
        if (state["path"] and state["path"] != new_path
                and os.path.exists(state["path"])):
            shutil.rmtree(state["path"])
        state["best"], state["path"] = score, new_path
        return True

    return save_best
