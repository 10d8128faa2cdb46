"""String-keyed component registries.

Counterpart of cross_modal_video_engine_tpu/utils/registry.py: the same
`Registry` class, so the config files' string keys (`type='Resize'`, ...)
name the same components in both packages.  The port registers only what
it has ported: the pipeline ops (data/pipelines.py, io/video_decode.py)
in `PIPELINES`, the 3D-CNN, 2D and transformer backbones (models/
{resnet3d,backbones2d,swin3d,mvit,videomae_vit,videoclip}.py ...) in
`BACKBONES`,
their heads (models/heads.py) in `HEADS`, the recognizers
(models/recognizer.py) in `RECOGNIZERS`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional


class Registry:
    """A name -> constructor mapping with decorator-style registration."""

    def __init__(self, name: str):
        self.name = name
        self._items: Dict[str, Any] = {}

    def register(self, key: Optional[str] = None) -> Callable:
        def deco(obj):
            k = key if key is not None else getattr(obj, "__name__", str(obj))
            if k in self._items:
                raise KeyError(f"{k!r} already registered in {self.name}")
            self._items[k] = obj
            return obj

        return deco

    def register_value(self, key: str, value: Any) -> None:
        if key in self._items:
            raise KeyError(f"{key!r} already registered in {self.name}")
        self._items[key] = value

    def get(self, key: str) -> Any:
        if key not in self._items:
            raise KeyError(
                f"{key!r} not found in registry {self.name}; "
                f"available: {sorted(self._items)}"
            )
        return self._items[key]

    def __contains__(self, key: str) -> bool:
        return key in self._items

    def __iter__(self) -> Iterator[str]:
        return iter(self._items)

    def keys(self):
        return self._items.keys()


PIPELINES = Registry("pipelines")
BACKBONES = Registry("backbones")
HEADS = Registry("heads")
RECOGNIZERS = Registry("recognizers")
