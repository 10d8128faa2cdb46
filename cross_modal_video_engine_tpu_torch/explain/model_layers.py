"""Default capture layers per model family.

A copy of cross_modal_video_engine_tpu/explain/model_layers.py.

Rebuild of MCT/tools/ctvs/ctv_construction/model_layers.py:1-459, which
maps model names to the dotted torch layer names hooked for CTV / grad
extraction.  Here layers are backbone BLOCK INDICES (the unit
forward_with_capture / score_from_layer operate on).
"""

from __future__ import annotations

from typing import Dict, List


def get_model_layers(model_name: str, num_layers: int = 12) -> Dict:
    """Returns {'capture': [block indices], 'target': grad-probe block}.

    Convention follows the reference: the grad probe sits on the last
    block with a patch-token gradient path (num_layers - 2) and captures
    span early/middle/late blocks."""
    name = model_name.lower()
    if "timesformer" in name or "vit" in name or "videomae" in name:
        last = num_layers - 2
        return {
            "capture": sorted({0, num_layers // 4, num_layers // 2,
                               3 * num_layers // 4, last}),
            "target": last,
        }
    if "swin" in name or "mvit" in name:
        return {"capture": list(range(num_layers)), "target": num_layers - 1}
    if "slowfast" in name or "resnet" in name or "x3d" in name:
        # CNN backbones expose stage outputs 0..3
        return {"capture": [0, 1, 2, 3], "target": 3}
    raise KeyError(f"no layer map for {model_name!r}")
