"""The card-vs-CPU check of one BatchNorm training step (`chip_smoke.py`
step 18b, `step_card_vs_cpu`) run on the CPU against itself, on a SlowFast
of the shipped recipe's layout cut to stage_blocks (1, 1, 1, 1) and width
8, 8 frames at 32²: the step passes its own check in f32 and in bf16, and
the check refuses every fault it plants (zero, random and negated
gradients, unmoved parameters, stale statistics), each in its own
sub-check; the same for step 19b's TRN and TPN recipes cut to the same
size (f32).  No JAX here: the check holds the step to float64."""

import numpy as np
import pytest
import torch

import chip_smoke


@pytest.fixture(autouse=True, scope="module")
def _own_threads_and_rng():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


def _config():
    cfg = chip_smoke.shipped_training_config(
        chip_smoke.SLOWFAST18_CONFIG, **{"optimizer.warmup_steps": 0})
    backbone = dict(cfg["model.backbone"], depth_blocks=[1, 1, 1, 1],
                    base_channels=8)
    cfg.set("model.backbone", backbone)
    return cfg


@pytest.mark.parametrize("start", ["init", "moved"])
def test_step_check_passes_itself_and_refuses_planted_faults(start):
    cfg = _config()
    rng = np.random.default_rng(18)
    clips = rng.uniform(-1, 1, (2, 8, 32, 32, 3)).astype(np.float32)
    labels = np.array([0, 7])
    state = None
    if start == "moved":
        from cross_modal_video_engine_tpu_torch.cli import recognition_train
        model = recognition_train.build_recognition_model(cfg, "cpu")
        with torch.no_grad():
            for p in model.parameters():
                p.add_(torch.from_numpy(rng.normal(
                    0, 0.05, tuple(p.shape)).astype(np.float32)))
        state = model.state_dict()
    line = chip_smoke.step_card_vs_cpu(torch.device("cpu"), cfg, clips,
                                       labels, state)
    assert line["failed"] == [] and line["f64_max_rel"] == 0.0
    for dtype in ("f32", "bf16"):
        planted = line[dtype]["planted"]
        for fault, sub in (("zero gradients", "gradients"),
                           ("random gradients", "gradients"),
                           ("negated gradients", "gradients"),
                           ("unmoved parameters", "update"),
                           ("stale statistics", "statistics")):
            assert planted[fault]["refused"], (dtype, fault, planted[fault])
            assert sub in planted[fault]["failed"]
        assert planted["one zero tensor"]["refused_in"] > 0
    # f32 at this width is well conditioned: one zeroed tensor is refused
    # in nearly every tensor
    f32 = line["f32"]["planted"]
    for fault in ("one zero tensor", "one negated tensor",
                  "one doubled tensor"):
        assert f32[fault]["refused_in"] >= 0.9 * f32[fault]["of"], f32[fault]


# step 19b's recipes cut the same way: TRN (its tuples one fixed draw on
# every run) and TPN over SlowOnly (the step adds loss_aux)
STEP19_CUTS = {
    "trn_r50_1x1x8": {"model.backbone.stage_blocks": [1, 1, 1, 1],
                      "model.backbone.base_channels": 8},
    "tpn_slowonly_r50_8x8": {
        "model.backbone.stage_blocks": [1, 1, 1, 1],
        "model.backbone.base_channels": 4,
        "model.neck": dict(type="TPN", in_channels=[64, 128],
                           out_channels=16, mid_channels=8,
                           lf_out_channels=16, fusion_channels=16,
                           groups=4, downsample_scales=[8, 8])}}


@pytest.mark.parametrize("name", list(STEP19_CUTS))
def test_step_check_covers_the_8b_steps(name):
    cfg = chip_smoke.shipped_training_config(
        chip_smoke.CNN_CONFIGS / chip_smoke.CNN19[name],
        **STEP19_CUTS[name])
    rng = np.random.default_rng(19)
    clips = rng.uniform(-1, 1, (2, 8, 32, 32, 3)).astype(np.float32)
    labels = np.array([0, 7])
    line = chip_smoke.step_card_vs_cpu(torch.device("cpu"), cfg, clips,
                                       labels, None, bf16s=(False,))
    assert line["failed"] == [] and line["f64_max_rel"] == 0.0
    assert "bf16" not in line
    planted = line["f32"]["planted"]
    assert all(planted[f]["refused"] for f in (
        "zero gradients", "random gradients", "negated gradients",
        "unmoved parameters", "stale statistics"))
    # the loss is the recipe's: TPN's includes its aux head's
    model = chip_smoke._start_model(cfg, torch.device("cpu"), None).train()
    loss = chip_smoke._train_loss(model, torch.from_numpy(clips),
                                  torch.from_numpy(labels))
    assert abs(float(loss) - line["f32"]["loss_cpu"]) <= 1e-5 * float(loss)


def test_float64_runs_stay_in_float64():
    """The witness's runs compute the loss, the TPN aux loss included, in
    float64 (a cross entropy taken in f32 puts the two devices' float64
    gradients 4e-9 of a tensor's largest apart, where they agree to
    1e-12)."""
    name = "tpn_slowonly_r50_8x8"
    cfg = chip_smoke.shipped_training_config(
        chip_smoke.CNN_CONFIGS / chip_smoke.CNN19[name],
        **STEP19_CUTS[name])
    model = chip_smoke._start_model(cfg, torch.device("cpu"),
                                    None).double().train()
    clips = torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 1, (2, 8, 32, 32, 3)))
    labels = torch.tensor([1, 2])
    _, aux = model(clips, target=labels)
    assert aux["loss_aux"].dtype == torch.float64
    assert chip_smoke._train_loss(model, clips, labels).dtype == \
        torch.float64


def test_per_tensor_bounds_hold_where_both_cpu_orders_agree():
    """A tensor is held alone where both CPU runs (two thread counts) lie
    within STEP18_GROSS[0] of float64; one that the CPU's summation order
    moves farther is left to the groups and the whole gradient."""
    truth = {"w": torch.tensor([1.0, 0.0], dtype=torch.float64),
             "v": torch.tensor([1.0, 0.0], dtype=torch.float64)}
    tt = {n: 1.0 for n in truth}
    near = torch.tensor([1.05, 0.0], dtype=torch.float64)
    runs = [{"grads": {"w": near, "v": near}},
            {"grads": {"w": near,
                       "v": torch.tensor([0.5, 0.5], dtype=torch.float64)}}]
    gate = chip_smoke._gate(runs, truth, tt)
    off = torch.tensor([0.3, 0.6], dtype=torch.float64)
    sums = chip_smoke._sums({"w": off, "v": off}, truth, runs[0]["grads"])
    assert not chip_smoke._tensor_ok(sums["w"], gate["w"], 1.0, 2)
    assert chip_smoke._tensor_ok(sums["v"], gate["v"], 1.0, 2)
    good = chip_smoke._sums({"w": near}, {"w": truth["w"]}, {"w": near})
    assert chip_smoke._tensor_ok(good["w"], gate["w"], 1.0, 2)


@pytest.mark.parametrize("card_err, held", [(1e-2, True), (3e-2, False)])
def test_group_bounds_read_the_worse_cpu_run(card_err, held):
    """A group's f32 bound is STEP18_ACC times the worse of the two CPU
    runs' L2 errors from float64 (here 1e-3 and 1e-2 of its norm), as the
    per-tensor gate reads both: a card at 1e-2 is held, one at 3e-2 is
    refused."""
    import types
    rng = np.random.default_rng(0)
    t = rng.standard_normal(400)
    t /= np.linalg.norm(t)

    def off(err, seed):
        d = np.random.default_rng(seed).standard_normal(400)
        d -= (d @ t) * t
        return torch.from_numpy(t + err * d / np.linalg.norm(d))

    lr = 0.1
    p0 = {"backbone.conv.weight": torch.zeros(400, dtype=torch.float64)}

    def run(g):
        return {"loss": 1.0, "grads": {"backbone.conv.weight": g},
                "p0": p0, "params": {n: p - lr * g for n, p in p0.items()},
                "s0": {}, "stats": {}}

    f64 = run(torch.from_numpy(t))
    cpu, alt = run(off(1e-3, 1)), run(off(1e-2, 2))
    card = run(off(card_err, 3))
    tcfg = types.SimpleNamespace(optimizer="sgd", grad_clip=1e9,
                                 weight_decay=0.0, learning_rate=lr)
    ref = chip_smoke._reference(cpu, f64, alt)
    failed, read = chip_smoke._step_verdict(card, cpu, f64, ref, tcfg, False)
    assert read["by_group"]["conv"]["cpu_l2_err"] == pytest.approx(1e-2)
    assert ("gradients" not in failed) is held
    # with the primary CPU run alone the bound is 2e-3: both are refused
    alone = chip_smoke._reference(cpu, f64)
    assert "gradients" in chip_smoke._step_verdict(
        card, cpu, f64, alone, tcfg, False)[0]


@pytest.mark.parametrize("name", ["slowfast", *STEP19_CUTS])
def test_shared_training_init_builds_the_same_models(name):
    """Inside shared_training_init a model is built with the same training
    init as outside it (drawn once, reused by the next build of the same
    structure), and the CLIs' functions are restored on leaving."""
    from cross_modal_video_engine_tpu_torch.cli import recognition_train
    cfg = _config() if name == "slowfast" else \
        chip_smoke.shipped_training_config(
            chip_smoke.CNN_CONFIGS / chip_smoke.CNN19[name],
            **STEP19_CUTS[name])
    build = recognition_train.build_recognition_model
    want = build(cfg, "cpu").state_dict()
    with chip_smoke.shared_training_init() as memo:
        runs = [recognition_train.build_recognition_model(cfg, "cpu")
                .state_dict() for _ in range(2)]
        assert len(memo) == 1
    assert recognition_train.build_recognition_model is build
    for got in runs:
        assert list(got) == list(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
