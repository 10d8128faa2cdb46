"""The localization CLI's four arms and the two localization tools of the
PyTorch port against the JAX package's CLIs, end to end on the CPU over
the JAX tests' small corpora (BMN T=20, N=4, D=20, hidden 16/8/16; TEM
hidden 16; PEM top_k 20; SSN T=24, 3 classes), a few epochs each.

Both CLIs start from the same init (the JAX modules' `init` patched to
the port's training init) and the BMN and PEM losses take the same draws
(the JAX CLI's own key-derived uniforms, handed to the port through
`train_from_config(draws=)`).  Tolerances, f32: each epoch's loss within
1e-5 relative, the final parameters within 1e-5 of each tensor's largest
magnitude, the reports (AR@AN, AUC, positive accuracy) within 1e-6.  Each
package reads the other's `*_final` checkpoint; the port reads its own
bit for bit.  `bsn_pgm` and `denormalize_proposals` write the JAX tools'
bytes.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu.cli import data_tools as jdt
from cross_modal_video_engine_tpu.cli import localization_train as jlt
from cross_modal_video_engine_tpu.cli import misc_tools as jmt
from cross_modal_video_engine_tpu.models import bmn as jbmn
from cross_modal_video_engine_tpu.models import bsn as jbsn
from cross_modal_video_engine_tpu.models import ssn as jssn
from cross_modal_video_engine_tpu.train.checkpoint import (
    load_checkpoint as jax_load_checkpoint)
from cross_modal_video_engine_tpu_torch.cli import data_tools as tdt
from cross_modal_video_engine_tpu_torch.cli import localization_train as tlt
from cross_modal_video_engine_tpu_torch.cli import misc_tools as tmt
from cross_modal_video_engine_tpu_torch.convert.from_jax import (
    localizer_state_dict_from_jax, localizer_variables_to_jax)
from cross_modal_video_engine_tpu_torch.models.recognizer import (
    conv_init_state_dict)

from torch_parity import max_rel, to_np

LOSS_REL, PARAM_TOL, REPORT_TOL = 1e-5, 1e-5, 1e-6
EPOCHS = 3


@pytest.fixture(autouse=True)
def _torch_rng():
    with torch.random.fork_rng():
        yield


def _corpus(tmp_path, rng, n=12, T=20, F=8):
    feat_dir = tmp_path / "feats"
    feat_dir.mkdir()
    ann = {}
    for i in range(n):
        s = rng.uniform(0.1, 0.5)
        e = s + rng.uniform(0.2, 0.4)
        dur = 100.0
        inside = (np.arange(T) / T >= s) & (np.arange(T) / T < e)
        feats = rng.standard_normal((T, F)).astype(np.float32) * 0.2
        feats[:, 0] += inside.astype(np.float32)   # channel 0 marks action
        np.save(feat_dir / f"v{i}.npy", feats)
        ann[f"v{i}"] = {"duration": dur,
                        "annotations": [{"segment": [s * dur, e * dur],
                                         "label": 1}]}
    ann_file = tmp_path / "ann.json"
    ann_file.write_text(json.dumps(ann))
    return str(ann_file), str(feat_dir)


def _pgm_corpus(tmp_path, rng, n=6, k=20, d=24):
    """PGM artifacts whose feature channel 0 encodes the match iou."""
    props_dir = tmp_path / "pgm_proposals"
    feats_dir = tmp_path / "pgm_features"
    props_dir.mkdir()
    feats_dir.mkdir()
    ann = {}
    for i in range(n):
        s, e = 0.3, 0.7
        ann[f"v{i}"] = {"duration": 50.0,
                        "annotations": [{"segment": [s * 50, e * 50],
                                         "label": 1}]}
        tmin = rng.uniform(0, 0.8, k)
        tmax = np.minimum(tmin + rng.uniform(0.05, 0.4, k), 1.0)
        tmin[:3] = [s, s - 0.02, s + 0.03]
        tmax[:3] = [e, e + 0.02, e - 0.03]
        inter = np.clip(np.minimum(tmax, e) - np.maximum(tmin, s), 0, None)
        iou = inter / ((tmax - tmin) + (e - s) - inter)
        rows = np.stack([tmin, tmax, np.full(k, 0.9), np.full(k, 0.9),
                         np.zeros(k), iou], 1)
        np.savetxt(props_dir / f"v{i}.csv", rows, delimiter=",",
                   fmt="%.6f", header="tmin,tmax,tmin_score,tmax_score,"
                                      "score,match_iou")
        feats = rng.normal(size=(k, d)).astype(np.float32) * 0.1
        feats[:, 0] = iou * 4.0
        np.save(feats_dir / f"v{i}.npy", feats)
    ann_file = tmp_path / "ann.json"
    ann_file.write_text(json.dumps(ann))
    return str(ann_file), str(props_dir), str(feats_dir)


def _ssn_corpus(tmp_path, rng, n=6, T=24, F=8, C=3):
    """A tag-style proposal file and snippet features where the gt class
    writes channel `label` inside its span."""
    feats_dir = tmp_path / "ssn_feats"
    feats_dir.mkdir()
    lines = []
    for i in range(n):
        frames, label, gs, ge = 48, (i % C) + 1, 12, 36
        feats = rng.normal(size=(T, F)).astype(np.float32) * 0.2
        feats[int(gs * T / frames):int(ge * T / frames), label] += 2.0
        np.save(feats_dir / f"v{i}.npy", feats)
        props = [(label, 0.9, 0.9, 13, 35), (label, 0.95, 0.95, 12, 36),
                 (label, 0.2, 0.6, 12, 20), (label, 0.25, 0.7, 28, 36),
                 (label, 0.15, 0.5, 18, 30), (0, 0.0, 0.0, 0, 10),
                 (0, 0.0, 0.0, 38, 47)]
        lines += [f"# {i}", f"v{i}", str(frames), "1.0", "1",
                  f"{label} {gs} {ge}", str(len(props))]
        lines += [" ".join(str(x) for x in p) for p in props]
    ann_file = tmp_path / "proposal_list.txt"
    ann_file.write_text("\n".join(lines) + "\n")
    return str(ann_file), str(feats_dir)


def _config(tmp_path, kind):
    rng = np.random.default_rng(761)
    if kind == "BMN":
        ann, feats = _corpus(tmp_path, rng)
        body = ("model = dict(type='BMN', temporal_dim=20, feat_dim=8, "
                "num_samples=4, max_duration=20, hidden_1d=16, hidden_2d=8, "
                "hidden_3d=16)\noptimizer = dict(optimizer='adamw', "
                "learning_rate=2e-3)\nbatch_size = 5\n")
        data = f"train=dict(ann_file=r'{ann}', feature_prefix=r'{feats}')"
    elif kind == "TEM":
        ann, feats = _corpus(tmp_path, rng, n=6, T=16)
        body = ("model = dict(type='TEM', temporal_dim=16, feat_dim=8, "
                "hidden=16)\noptimizer = dict(learning_rate=3e-3, "
                "weight_decay=1e-4)\nbatch_size = 4\n")
        data = f"train=dict(ann_file=r'{ann}', feature_prefix=r'{feats}')"
    elif kind == "PEM":
        ann, props, feats = _pgm_corpus(tmp_path, rng)
        body = ("model = dict(type='PEM', feat_dim=32, hidden=16, top_k=20, "
                "u_ratio_m=1.0, u_ratio_l=2.0, post_process_top_k=20)\n"
                "optimizer = dict(optimizer='adam', learning_rate=0.02, "
                "weight_decay=1e-5)\nbatch_size = 4\n")
        data = (f"train=dict(ann_file=r'{ann}', pgm_proposals_dir="
                f"r'{props}', pgm_features_dir=r'{feats}')")
    else:
        ann, feats = _ssn_corpus(tmp_path, rng)
        body = ("model = dict(type='SSN', temporal_dim=24, feat_dim=8, "
                "num_classes=3, parts=[1, 2, 1], hidden=16)\n"
                "sampler = dict(positive_per_video=1, incomplete_per_video=2,"
                " background_per_video=1, background_coverage=0.02)\n"
                "ssn = dict(comp_loss_weight=0.1, reg_loss_weight=0.1)\n"
                "optimizer = dict(optimizer='sgd', learning_rate=0.05, "
                "momentum=0.9, weight_decay=1e-4)\nbatch_size = 4\n")
        data = f"train=dict(ann_file=r'{ann}', feature_prefix=r'{feats}')"
    cfg = tmp_path / f"{kind.lower()}.py"
    cfg.write_text(body + f"data = dict({data},\n    "
                   f"{data.replace('train=', 'val=', 1)})\n"
                   f"total_epochs = {EPOCHS}\n")
    return str(cfg)


JAX_MODELS = {"BMN": jbmn.BMN, "TEM": jbsn.TEM, "PEM": jbsn.PEM,
              "SSN": jssn.SSNHead}


def _port_init(monkeypatch, kind):
    """Patch the JAX module's init to the port's training init of the
    model the port's CLI builds (the same structure and seed)."""
    made = {}

    def init(self, key, *args, **kw):
        from cross_modal_video_engine_tpu_torch.models import bmn, bsn, ssn
        if kind == "BMN":
            m = bmn.BMN(bmn.BMNConfig(**vars(self.cfg)), device="meta")
        elif kind == "TEM":
            m = bsn.TEM(args[0].shape[-1], self.hidden, device="meta")
        elif kind == "PEM":
            m = bsn.PEM(args[0].shape[-1], self.hidden, device="meta")
        else:
            c = self.cfg
            m = ssn.SSNHead(ssn.SSNConfig(c.feat_dim, c.num_classes,
                                          tuple(c.parts), c.hidden),
                            device="meta")
        made["init"] = localizer_variables_to_jax(conv_init_state_dict(m, 0))
        return jax.tree.map(jnp.asarray, made["init"])

    monkeypatch.setattr(JAX_MODELS[kind], "init", init)
    return made


def _jax_draws(seed):
    """The JAX CLI's draws at each step: rng, sub = split(rng), then one
    uniform from each half of split(sub)."""
    state = {"rng": jax.random.key(seed), "n": 0}

    def draws(step, shape):
        assert step == state["n"]
        state["rng"], sub = jax.random.split(state["rng"])
        state["n"] += 1
        km, kl = jax.random.split(sub)
        return (np.asarray(jax.random.uniform(km, shape)),
                np.asarray(jax.random.uniform(kl, shape)))

    return draws


@pytest.mark.parametrize("kind", ["BMN", "TEM", "PEM", "SSN"])
def test_cli_arm_matches_jax(kind, tmp_path, monkeypatch, capsys):
    cfg = _config(tmp_path, kind)
    made = _port_init(monkeypatch, kind)
    jwork, twork = str(tmp_path / "jax"), str(tmp_path / "port")
    jhist, jrep = jlt.main([cfg, "--work_dir", jwork])
    from cross_modal_video_engine_tpu_torch.config import Config
    model, thist, trep = tlt.train_from_config(
        Config.fromfile(cfg), twork, device="cpu",
        draws=_jax_draws({"BMN": 0, "PEM": 1}.get(kind, 0)))
    assert "init" in made
    assert [h["epoch"] for h in thist] == list(range(EPOCHS))
    for a, b in zip(thist, jhist):
        assert abs(a["loss"] - b["loss"]) <= LOSS_REL * abs(b["loss"]), kind
    assert sorted(trep) == sorted(jrep)
    for k in jrep:
        assert trep[k] == pytest.approx(jrep[k], abs=REPORT_TOL), (kind, k)

    name = {"BMN": "bmn_final", "TEM": "tem_final", "PEM": "pem_final",
            "SSN": "ssn_final"}[kind]
    # the port reads its own checkpoint bit for bit, and the JAX one
    own = tlt.load_localizer(os.path.join(twork, name), kind, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(own.state_dict()[k], v), k
    theirs = tlt.load_localizer(os.path.join(jwork, name), kind,
                                device="cpu").state_dict()
    for k, v in model.state_dict().items():
        assert max_rel(to_np(v), to_np(theirs[k])) <= PARAM_TOL, (kind, k)
    # the JAX package reads the port's checkpoint: the same tree
    jv, jcfg, jmeta = jax_load_checkpoint(os.path.join(twork, name))
    back = localizer_state_dict_from_jax(jv)
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k
    _, want_cfg, want_meta = jax_load_checkpoint(os.path.join(jwork, name))
    assert jcfg == want_cfg and sorted(jmeta) == sorted(want_meta)
    capsys.readouterr()


def test_bsn_pgm_writes_the_jax_bytes(tmp_path, capsys):
    """TEM curves (one video with no boundary at all: the placeholder
    row) through both tools: the same csv and npy bytes."""
    rng = np.random.default_rng(5)
    tem = tmp_path / "tem"
    tem.mkdir()
    ann = {}
    for i, T in enumerate((50, 40, 30)):
        curves = {k: rng.uniform(0, 1, T).astype(np.float32)
                  for k in ("action", "start", "end")}
        if i == 2:
            curves = {k: np.zeros(T, np.float32) for k in curves}
        np.savez(tem / f"v{i}.npz", **curves)
        ann[f"v{i}"] = {"duration": 10.0, "annotations": [
            {"segment": [2.0 + i, 6.0], "label": 0}]}
    (tmp_path / "ann.json").write_text(json.dumps(ann))
    outs = {}
    for name, main in (("jax", jmt.main), ("port", tmt.main)):
        p, f = tmp_path / name / "p", tmp_path / name / "f"
        main(["bsn_pgm", "--tem_dir", str(tem), "--proposals_dir", str(p),
              "--features_dir", str(f), "--ann_file",
              str(tmp_path / "ann.json"), "--max_proposals", "40"])
        outs[name] = {str(x.relative_to(tmp_path / name)): x.read_bytes()
                      for x in sorted((tmp_path / name).rglob("*.*"))}
    assert len(outs["port"]) == 6 and outs["port"] == outs["jax"]
    capsys.readouterr()


def test_denormalize_proposals_writes_the_jax_bytes(tmp_path, capsys):
    rng = np.random.default_rng(6)
    lines = []
    for i in range(3):
        n_gt, n_prop = 2, 4
        lines += [f"# {i}", f"vid{i}", "1", "1", str(n_gt)]
        lines += [f"{i + 1} {a:.4f} {b:.4f}" for a, b in
                  np.sort(rng.uniform(0, 1, (n_gt, 2)), -1)]
        lines += [str(n_prop)]
        lines += [f"{i} {rng.uniform():.4f} {rng.uniform():.4f} "
                  f"{a:.4f} {b:.4f}"
                  for a, b in np.sort(rng.uniform(0, 1, (n_prop, 2)), -1)]
        frames = tmp_path / "frames" / f"vid{i}"
        frames.mkdir(parents=True)
        for j in range(17 + 5 * i):
            (frames / f"img_{j:05d}.jpg").write_bytes(b"x")
    norm = tmp_path / "normalized_props.txt"
    norm.write_text("\n".join(lines) + "\n")
    for name, main in (("jax", jdt.main), ("port", tdt.main)):
        main(["denormalize_proposals", "--input", str(norm), "--frames_dir",
              str(tmp_path / "frames"), "--output",
              str(tmp_path / f"{name}.txt")])
    assert (tmp_path / "port.txt").read_bytes() == \
        (tmp_path / "jax.txt").read_bytes()
    capsys.readouterr()


# the subcommands the port still refuses, by the part that ports them
REFUSED_PART = {"build_audio_features": "8g"}


@pytest.mark.parametrize("tool,argv", [
    (tdt, ["build_audio_features", "--src_dir", "a", "--out_dir", "b"]),
])
def test_other_tools_name_their_part(tool, argv):
    with pytest.raises(NotImplementedError,
                       match=f"item {REFUSED_PART[argv[0]]}"):
        tool.main(argv)
    with pytest.raises(SystemExit):
        tool.main(["denormalize_proposals" if tool is tdt else "bsn_pgm",
                   "--no_such_flag"])
