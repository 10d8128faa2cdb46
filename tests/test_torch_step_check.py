"""The card-vs-CPU check of one BatchNorm training step (`chip_smoke.py`
step 18b, `step_card_vs_cpu`) run on the CPU against itself, on a SlowFast
of the shipped recipe's layout cut to stage_blocks (1, 1, 1, 1) and width
8, 8 frames at 32²: the step passes its own check in f32 and in bf16, and
the check refuses every fault it plants (zero, random and negated
gradients, unmoved parameters, stale statistics), each in its own
sub-check.  No JAX here: the check holds the step to float64."""

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
