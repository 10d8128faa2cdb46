"""A trainer's whole state, saved and resumed.

Counterpart of cross_modal_video_engine_tpu/train/resume.py in the same
files, so a run either package saved resumes in the other:

* `train_state.msgpack`: flax's msgpack form (io/flax_msgpack.py) of the
  payload as the JAX package writes it, for
  - the LINAS trainer, `{"state": TrainState, "mask": MaskState}`:
    /state/params/..., /state/batch_stats/..., /state/opt_state/{count,
    hyperparams/learning_rate, hyperparams_states, inner_state/1/0/{count,
    mu, nu}}, and for an 'adapt' run /mask/0 (pa) and /mask/1/1/0/{count,
    mu, nu} (convert/from_jax.py's `linas_*_state_{to,from}_jax`);
  - the recognition and caption trainers, `{"state": RecTrainState,
    "batch_stats": ...}` as their CLIs write it: /batch_stats (nil for
    the TimeSformer, which has no BatchNorm; a 3D-CNN's running
    statistics in the JAX tree, `{"backbone": ...}`), /state/params/...,
    /state/opt_state/ (make_rec_optimizer's chain) and /state/step
    (`rec_train_state_{to,from}_jax`).  The port's statistics live in the
    model's buffers: its payload's "batch_stats" is None or the module
    that holds them (the state's model);
  - the OmniSource loop's epochs, `{"params", "batch_stats",
    "opt_state"}` as the JAX CLI writes them (/batch_stats empty without
    BatchNorm): the port's payload is `{"omnisource": RecTrainState,
    "batch_stats": None or the model}`, its loop state `{epoch, it}`;
  - the detector trainers, `{"state": YoloTrainState}` as the JAX
    `cli/yolo_train.py` and `cli/yolo_cls_train.py` write `tuple(state)`:
    /state/0 params, /1 batch_stats, /2 vel, /3 ema_params, /4 ema_stats,
    /5 updates (`yolo_train_state_{to,from}_jax`);
  - the detector's `best/` directory, `{"params", "batch_stats"}` as
    the JAX `cli/yolo_train.py` writes its EMA weights there
    (`yolo{,_cls}_{state_dict_from,variables_to}_jax`): the port's payload
    is `{"detector": YoloV5 or YoloClassifier}`;
* `loop_state.json`: the host loop's state ({epoch, ...}; a detector's
  `anchors` in pixels, which `load_train_state` applies to the model;
  the detector trainers' `best` fitness).

`load_train_state` restores into the given states in place.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from ..convert.from_jax import (conv_batch_stats_from_jax,
                                conv_recognizer_variables_to_jax,
                                linas_mask_state_from_jax,
                                yolo_cls_state_dict_from_jax,
                                yolo_cls_variables_to_jax,
                                yolo_state_dict_from_jax,
                                yolo_variables_to_jax,
                                linas_mask_state_to_jax,
                                linas_train_state_from_jax,
                                linas_train_state_to_jax,
                                rec_train_state_from_jax,
                                rec_train_state_to_jax,
                                yolo_train_state_from_jax,
                                yolo_train_state_to_jax)
from ..io import flax_msgpack
from ..models.timesformer import TimeSformerConfig
from .checkpoint import _host_tree
from .recognition_trainer import RecTrainState
from .yolo_trainer import YoloTrainState

STATE_FILE, LOOP_FILE = "train_state.msgpack", "loop_state.json"


def _chain(opt) -> Dict[str, Any]:
    """The optimizer's chain: its kind and whether a clip leads it."""
    return {"kind": opt.kind, "clip": opt.max_norm is not None}


def _rec_layout(model):
    """What names a recognizer's JAX tree: the TimeSformer config, or the
    CNN or transformer recognizer itself (convert/from_jax.py)."""
    cfg = getattr(getattr(model, "backbone", None), "cfg", None)
    return cfg if isinstance(cfg, TimeSformerConfig) else model


def _rec_to_tree(payload: Dict[str, Any]) -> Dict[str, Any]:
    state = payload["state"]
    opt = state.optimizer
    holder = payload.get("batch_stats")
    stats = None if holder is None else conv_recognizer_variables_to_jax(
        holder.state_dict(), holder)["batch_stats"]
    tree = _host_tree({"batch_stats": stats, "state": rec_train_state_to_jax(
        state.model.state_dict(), opt.named_state(), state.step,
        _rec_layout(state.model), schedule=opt.scheduled, **_chain(opt))})
    tree["state"] = {k: tree["state"][k]
                     for k in ("params", "opt_state", "step")}
    return tree


def _load_rec_state(state: RecTrainState, tree: Dict[str, Any], holder,
                    stats) -> int:
    """A RecTrainState's tree (params, opt_state, step) and the
    statistics into the state's model and optimizer; returns the step."""
    opt = state.optimizer
    sd, named, step = rec_train_state_from_jax(
        tree, _rec_layout(state.model), **_chain(opt))
    _load_strict(state.model, sd, buffers=False)
    opt.load_named_state(named)
    _load_batch_stats(holder, stats)
    return step


def _load_batch_stats(holder, stats) -> None:
    """The file's batch_stats into the holder's BatchNorm buffers."""
    if (holder is None) != (stats is None):
        raise ValueError(
            f"the file has {'no ' if stats is None else ''}batch_stats; the "
            f"payload names {'no' if holder is None else 'a'} model holding "
            f"BatchNorm statistics")
    if holder is not None:
        holder.load_state_dict(conv_batch_stats_from_jax(stats, holder),
                               strict=False)


def _is_classifier(model) -> bool:
    return "model.9.linear.weight" in model.state_dict()


def _detector_to_tree(model) -> Dict[str, Any]:
    to_jax = (yolo_cls_variables_to_jax if _is_classifier(model)
              else yolo_variables_to_jax)
    return _host_tree(to_jax(model.state_dict(), model.cfg))


_YOLO_FIELDS = ("params", "batch_stats", "vel", "ema_params", "ema_stats",
                "updates")


def _yolo_state_to_tree(state: YoloTrainState) -> Dict[str, Any]:
    """tuple(YoloTrainState) as flax writes a tuple: keys "0" ... "5"."""
    fields = yolo_train_state_to_jax(
        state.model.state_dict(), state.vel, state.ema.state_dict(),
        state.updates, state.model.cfg, _is_classifier(state.model))
    return {"state": _host_tree({str(i): fields[k]
                                 for i, k in enumerate(_YOLO_FIELDS)})}


def _load_yolo_state(state: YoloTrainState, tree: Dict[str, Any],
                     loop_state: Dict) -> YoloTrainState:
    for m in (state.model, state.ema):
        _apply_anchors(m, loop_state)
    fields = {k: tree[str(i)] for i, k in enumerate(_YOLO_FIELDS)}
    sd, vel, ema, updates = yolo_train_state_from_jax(
        fields, state.model.cfg, _is_classifier(state.model))
    _load_strict(state.model, sd)
    _load_strict(state.ema, ema)
    with torch.no_grad():
        for n, v in vel.items():
            state.vel[n].copy_(v)
    return state._replace(updates=updates)


def _apply_anchors(model, loop_state: Dict) -> None:
    """The loop state's anchors (pixels) replace the model config's, and
    the Detect head's anchors buffer follows."""
    import dataclasses
    if loop_state.get("anchors") and not _is_classifier(model):
        anchors = tuple(tuple(tuple(a) for a in layer)
                        for layer in loop_state["anchors"])
        model.cfg = dataclasses.replace(model.cfg, anchors=anchors)


def _load_strict(model, sd: Dict[str, torch.Tensor],
                 buffers: bool = True) -> None:
    """sd into the model; every parameter (and, with buffers, every buffer
    but num_batches_tracked) must be in it."""
    model.load_state_dict(sd, strict=False)
    want = set(model.state_dict()) if buffers \
        else {n for n, _ in model.named_parameters()}
    missing = want - set(sd)
    if any(not k.endswith("num_batches_tracked") for k in missing):
        raise KeyError(f"not in the checkpoint: {sorted(missing)[:5]}")


def _load_detector(model, tree: Dict[str, Any], loop_state: Dict) -> None:
    """The file's {"params", "batch_stats"} into the detector, after the
    loop state's anchors (pixels) replace its config's."""
    _apply_anchors(model, loop_state)
    from_jax = (yolo_cls_state_dict_from_jax if _is_classifier(model)
                else yolo_state_dict_from_jax)
    _load_strict(model, from_jax(tree, model.cfg))


def _omnisource_to_tree(payload: Dict[str, Any]) -> Dict[str, Any]:
    tree = _rec_to_tree({"state": payload["omnisource"],
                         "batch_stats": payload.get("batch_stats")})
    return {"batch_stats": tree["batch_stats"] or {},
            "opt_state": tree["state"]["opt_state"],
            "params": tree["state"]["params"]}


def _to_tree(payload: Dict[str, Any]) -> Dict[str, Any]:
    """The payload's tree in the JAX package's order: dict keys sorted, as
    jax.tree.map leaves them, but TrainState's and RecTrainState's fields
    in field order (the optax states' fields are sorted already), so both
    packages write the same bytes for the same state."""
    if "detector" in payload:
        return _detector_to_tree(payload["detector"])
    if "omnisource" in payload:
        return _omnisource_to_tree(payload)
    if isinstance(payload["state"], YoloTrainState):
        return _yolo_state_to_tree(payload["state"])
    if isinstance(payload["state"], RecTrainState):
        return _rec_to_tree(payload)
    tree = {}
    if "mask" in payload:
        mask = payload["mask"]
        tree["mask"] = linas_mask_state_to_jax(
            mask.pa, mask.optimizer.named_state())
    state = payload["state"]
    tree["state"] = linas_train_state_to_jax(
        state.model.state_dict(), state.optimizer.named_state())
    tree = _host_tree(tree)
    tree["state"] = {k: tree["state"][k]
                     for k in ("params", "batch_stats", "opt_state")}
    return tree


def save_train_state(path: str, payload: Dict[str, Any],
                     loop_state: Optional[Dict] = None) -> None:
    """payload: {"state": TrainState[, "mask": MaskState]}, {"state":
    RecTrainState, "batch_stats": None or the model holding the
    statistics}, {"omnisource": RecTrainState, "batch_stats": ...},
    {"state": YoloTrainState} or {"detector": model}."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, STATE_FILE), "wb") as f:
        f.write(flax_msgpack.to_bytes(_to_tree(payload)))
    with open(os.path.join(path, LOOP_FILE), "w") as f:
        json.dump(loop_state or {}, f)


def load_train_state(path: str, payload: Dict[str, Any]
                     ) -> Tuple[Dict[str, Any], Dict]:
    """payload: the states to restore into, {"state": TrainState[, "mask":
    MaskState]}, {"state": RecTrainState, "batch_stats": None or the
    model holding the statistics},
    {"state": YoloTrainState} or {"detector": YoloV5 or YoloClassifier} (a
    detector's cfg takes the loop state's anchors); each
    entry found in the file is loaded in place.  Returns (the payload
    restored, loop state); a RecTrainState comes back with the file's
    step, a YoloTrainState with its update count."""
    with open(os.path.join(path, STATE_FILE), "rb") as f:
        tree = flax_msgpack.restore(f.read())
    loop_state = {}
    p = os.path.join(path, LOOP_FILE)
    if os.path.exists(p):
        with open(p) as f:
            loop_state = json.load(f)
    if "detector" in payload:
        _load_detector(payload["detector"], tree, loop_state)
        return {"detector": payload["detector"]}, loop_state
    if "omnisource" in payload:
        state = payload["omnisource"]
        _load_rec_state(state, dict(tree, step=0),
                        payload.get("batch_stats"),
                        tree.get("batch_stats") or None)
        return {"omnisource": state,
                "batch_stats": payload.get("batch_stats")}, loop_state
    restored = {}
    state = payload["state"]
    if isinstance(state, YoloTrainState):
        return {"state": _load_yolo_state(state, tree["state"],
                                          loop_state)}, loop_state
    if isinstance(state, RecTrainState):
        step = _load_rec_state(state, tree["state"],
                               payload.get("batch_stats"),
                               tree.get("batch_stats"))
        restored.update(state=state._replace(step=step),
                        batch_stats=payload.get("batch_stats"))
    else:
        sd, named = linas_train_state_from_jax(tree["state"],
                                               state.model.cfg)
        state.model.load_state_dict(sd)
        state.optimizer.load_named_state(named)
        restored["state"] = state
    if "mask" in payload and "mask" in tree:
        mask = payload["mask"]
        pa, named = linas_mask_state_from_jax(tree["mask"])
        with torch.no_grad():
            mask.pa.copy_(pa)
        mask.optimizer.load_named_state(named)
        restored["mask"] = mask
    return restored, loop_state


def latest_checkpoint(root: str, prefix: str = "epoch_") -> Optional[str]:
    """The newest `{prefix}{n}` directory under root, or None."""
    if not os.path.isdir(root):
        return None
    best, best_n = None, -1
    for d in os.listdir(root):
        if d.startswith(prefix):
            try:
                n = int(d[len(prefix):])
            except ValueError:
                continue
            if n > best_n:
                best_n, best = n, os.path.join(root, d)
    return best
