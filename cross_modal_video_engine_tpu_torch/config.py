"""Config trees from the repository's config files.

Counterpart of cross_modal_video_engine_tpu/config.py: ONE dict-tree
`Config` with

  * `Config.fromfile` for python files defining plain dicts (mmcv-style,
    with `_base_` inheritance and `_delete_=True` replacing a base dict),
    or a json file;
  * `merge_from_options` for dotted overrides (`model.backbone.depth=50`);
  * `get`/`__getitem__` with dotted keys;
  * `to_dataclass` to build one of the port's typed configs
    (TimeSformerConfig, RNNDecoderConfig, ...) from a sub-tree.

Both packages load every file under configs/ to the same tree.
"""

from __future__ import annotations

import ast
import copy
import dataclasses
import importlib.util
import json
import os
from typing import Any, Dict, List, Optional, Type


class Config:
    def __init__(self, tree: Optional[Dict] = None):
        self._tree = dict(tree or {})

    # -- access ----------------------------------------------------------
    def __getitem__(self, key: str):
        node: Any = self._tree
        for part in key.split("."):
            node = node[part]
        return node

    def get(self, key: str, default=None):
        try:
            return self[key]
        except (KeyError, TypeError):
            return default

    def __contains__(self, key: str) -> bool:
        try:
            self[key]
            return True
        except (KeyError, TypeError):
            return False

    def set(self, key: str, value) -> None:
        parts = key.split(".")
        node = self._tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def to_dict(self) -> Dict:
        return copy.deepcopy(self._tree)

    # -- loading ----------------------------------------------------------
    @classmethod
    def fromfile(cls, path: str) -> "Config":
        if path.endswith(".json"):
            with open(path) as f:
                return cls(json.load(f))
        spec = importlib.util.spec_from_file_location("_cfg", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        tree = {k: v for k, v in vars(mod).items()
                if not k.startswith("_") and not callable(v)
                and not isinstance(v, type(os))}
        bases = getattr(mod, "_base_", None)
        if bases:
            if isinstance(bases, str):
                bases = [bases]
            merged: Dict = {}
            for b in bases:
                base_cfg = cls.fromfile(
                    os.path.join(os.path.dirname(path), b))
                _deep_merge(merged, base_cfg._tree)
            _deep_merge(merged, tree)
            tree = merged
        tree.pop("_base_", None)
        return cls(tree)

    def merge_from_options(self, options: List[str]) -> "Config":
        """options: ['a.b=3', "c.d='x'"] — values parsed as python
        literals with string fallback."""
        for opt in options:
            key, _, raw = opt.partition("=")
            try:
                value = ast.literal_eval(raw)
            except (ValueError, SyntaxError):
                value = raw
            self.set(key.strip(), value)
        return self

    def merge(self, other: Dict) -> "Config":
        _deep_merge(self._tree, other)
        return self

    # -- typed materialization ---------------------------------------------
    def to_dataclass(self, cls_type: Type, key: Optional[str] = None):
        """cls_type built from the sub-tree at `key` (the whole tree by
        default): keys that are not fields are dropped, lists become
        tuples where the field is a Tuple."""
        sub = self[key] if key else self._tree
        fields = {f.name: f for f in dataclasses.fields(cls_type)}
        kwargs = {}
        for k, v in sub.items():
            if k not in fields:
                continue
            if isinstance(v, list) and "Tuple" in str(fields[k].type):
                v = tuple(v)
            kwargs[k] = v
        return cls_type(**kwargs)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self._tree, f, indent=1, default=str)


def _strip_delete(v):
    """Deep-copy v with every nested `_delete_` flag removed (it is a
    merge directive, not config content)."""
    if isinstance(v, dict):
        return {k: _strip_delete(x) for k, x in v.items()
                if k != "_delete_"}
    return copy.deepcopy(v)


def _deep_merge(dst: Dict, src: Dict) -> Dict:
    for k, v in src.items():
        if isinstance(v, dict) and v.get("_delete_", False):
            # `_delete_=True` replaces the base dict wholesale instead of
            # deep-merging into it.  Read, don't pop: src belongs to the
            # caller and may be merged again
            dst[k] = _strip_delete(v)
        elif isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = _strip_delete(v)
    return dst
