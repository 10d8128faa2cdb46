"""The port's bench entry points (entry.py, bench/, utils/profiling.py) on
the CPU at tiny sizes: every bench function runs, prints one JSON line per
row with the keys of bench.py's format and finite values, and names the
CPU as where it ran; `entry()`'s output agrees with the JAX package's
flagship model on the same weights.  Times taken here are CPU times and
are not looked at: the rows' numbers come from the card."""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cross_modal_video_engine_tpu.convert import convert_clip_vit
from cross_modal_video_engine_tpu.models import clip as jclip
from cross_modal_video_engine_tpu_torch.bench import (block_ab, common, extra,
                                                      headline)
from cross_modal_video_engine_tpu_torch.entry import entry
from cross_modal_video_engine_tpu_torch.models import clip as tclip
from cross_modal_video_engine_tpu_torch.ops import attention_sublayer as tasl
from cross_modal_video_engine_tpu_torch.utils.device import resolve_device
from cross_modal_video_engine_tpu_torch.utils.profiling import (StageTimer,
                                                                device_time)

from torch_parity import interpret_pallas, min_cosine


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    """One torch thread (the lane runs several xdist workers), and torch's
    global RNG and thread count left as found for the other test files
    this worker runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


SMALL = dict(embed_dim=16, image_resolution=32, vision_width=64,
             vision_layers=2, vision_heads=4, patch_size=8, context_length=8,
             vocab_size=64, text_width=32, text_heads=2, text_layers=2)
ROW_KEYS = {"metric", "value", "unit", "vs_baseline", "device",
            "power_limit", "torch", "cuda"}


def _rows(capsys):
    """The JSON lines printed since the last call: one object a line."""
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    return [json.loads(l) for l in lines]


def _check_rows(rows, metrics):
    assert [r["metric"] for r in rows] == metrics
    for r in rows:
        assert ROW_KEYS <= set(r), sorted(ROW_KEYS - set(r))
        assert r["device"] == "cpu" and r["power_limit"] is None
        assert math.isfinite(r["value"]) and r["value"] > 0
        assert r["vs_baseline"] is None or math.isfinite(r["vs_baseline"])
        assert not r["unit"].endswith(("/chip", "/device"))   # a CPU run


def test_resolve_device_defaults_to_the_card():
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cuda", 1)).index == 1


def test_entry_points_default_to_the_card():
    """No argument means the CUDA device; where there is none (here),
    torch's own error surfaces and nothing runs on the CPU instead."""
    from cross_modal_video_engine_tpu_torch.retrieval import RetrievalIndex
    cfg = tclip.CLIPConfig(**SMALL)
    for build in (lambda: entry(cfg=cfg),
                  lambda: tclip.CLIPModel(cfg),
                  lambda: RetrievalIndex(np.zeros((4, 8), np.float32)),
                  lambda: headline.bench_headline(batch=1, frames=1, steps=1,
                                                  cfg=cfg),
                  lambda: block_ab.bench_op_level(nseq=2, seq_len=10,
                                                  width=64, heads=4,
                                                  layers=1, steps=1),
                  lambda: extra.bench_text_tower(batch=2, steps=1, cfg=cfg)):
        if torch.cuda.is_available():
            continue
        with pytest.raises((AssertionError, RuntimeError),
                           match="(?i)cuda|nvidia"):
            build()


def test_device_time_and_stage_timer():
    calls = []
    x = torch.ones(4)
    seconds = device_time(lambda t: calls.append(float(t.sum())), x, steps=3,
                          warmup=2)
    assert len(calls) == 5 and seconds >= 0
    timer = StageTimer()
    for _ in range(2):
        with timer.stage("embed", sync_value=x):
            pass
    report = timer.report()
    assert report["embed"]["count"] == 2
    assert report["embed"]["mean_s"] == report["embed"]["total_s"] / 2


def test_seeded_state_dict_is_the_bench_programs_draw():
    cfg = tclip.CLIPConfig(**SMALL)
    sd = common.seeded_state_dict(cfg, seed=0)
    again = common.seeded_state_dict(cfg, seed=0)
    assert list(sd) == list(tclip.CLIPModel(cfg, device="meta").state_dict())
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    flat = torch.cat([t.flatten() for t in sd.values()])
    assert abs(float(flat.std()) - 0.02) < 1e-3 and abs(float(flat.mean())) < 1e-3


@pytest.mark.parametrize("dtype,floor", [("float32", 0.999999),
                                         ("bfloat16", 0.9999)])
def test_entry_matches_the_jax_flagship_model(dtype, floor, monkeypatch):
    """The flagship program at 2 layers and a narrow width: the port's
    `entry()` against the JAX CLIPModel (fused sublayers, Pallas
    interpreter) on the port's weights through convert_clip_vit."""
    interpret_pallas(monkeypatch)
    flags = dict(dtype=dtype, fused_attn=True, fused_mlp=True)
    fn, (model, clip) = entry("cpu", cfg=tclip.CLIPConfig(**SMALL, **flags))
    got = fn(model, clip)
    assert tuple(got.shape) == (2, 8, 16) and got.dtype == torch.float32
    assert tuple(clip.shape) == (2, 8, 32, 32, 3)
    jcfg = jclip.CLIPConfig(**SMALL, **flags)
    variables = convert_clip_vit(
        {k: v.float() for k, v in model.state_dict().items()}, jcfg)
    want, _ = jclip.CLIPModel(jcfg).apply(
        variables, jnp.asarray(clip.numpy()), method="encode_video")
    assert min_cosine(got.numpy(), np.asarray(want, np.float32)) >= floor


def test_headline_row(capsys):
    cfg = common.flagship_config(**SMALL)
    row = headline.bench_headline(batch=2, frames=2, steps=1, device="cpu",
                                  cfg=cfg)
    rows = _rows(capsys)
    _check_rows(rows, [headline.METRIC])
    assert rows[0] == json.loads(json.dumps(row))
    assert rows[0]["vs_baseline"] == pytest.approx(
        rows[0]["value"] / rows[0]["plain"])
    assert set(rows[0]["runs"]) == {"plain", "kernel"}


def test_block_ab_rows_and_stacks_agree(capsys):
    kw = dict(nseq=4, seq_len=10, width=64, heads=4, layers=2)
    rows = block_ab.bench_op_level(**kw, steps=1, device="cpu")
    printed = _rows(capsys)
    _check_rows(printed, ["stack2_two_kernels", "stack2_whole_block"])
    assert printed[1]["speedup_vs_two_kernels"] == pytest.approx(
        rows[0]["value"] / rows[1]["value"])
    x, params = block_ab.build_stack(4, 10, 64, 2, "cpu")
    assert x.dtype == torch.bfloat16 and tuple(x.shape) == (40, 64)
    assert tuple(params[0][1][2].shape) == (256, 64)        # Linear layout
    two = block_ab.stack_two(x, params, heads=4, seq_len=10)
    blk = block_ab.stack_block(x, params, heads=4, seq_len=10)
    assert torch.equal(two, blk)         # on the CPU: the same plain math
    # the first layer is fused_block_sublayer_compact on those weights
    assert torch.equal(
        block_ab.stack_block(x, params[:1], heads=4, seq_len=10),
        tasl._block_ref_flat(x, *params[0][0], *params[0][1], heads=4,
                             seq_len=10, causal=False))


def test_block_ab_model_level_rows(capsys):
    cfg = common.flagship_config(**SMALL)
    block_ab.bench_model_level(batch=2, frames=2, steps=1, repeats=2,
                               device="cpu", cfg=cfg)
    rows = _rows(capsys)
    _check_rows(rows, ["headline_compact_attn+mlp",
                       "headline_compact_attn_only",
                       "fused_mlp_on_compact_verdict"])
    assert len(rows[0]["runs"]) == 2
    assert rows[2]["value"] == pytest.approx(rows[0]["value"]
                                             / rows[1]["value"])


def test_block_ab_main_writes_its_rows(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(block_ab, "bench_op_level",
                        lambda device=None, out=None: out.append({"a": 1}))
    out = tmp_path / "rows.jsonl"
    block_ab.main(["--skip-model", "--device", "cpu", "--out", str(out)])
    assert [json.loads(l) for l in out.read_text().splitlines()] == [{"a": 1}]


def test_retrieval_rows(capsys):
    extra.bench_retrieval_p50(n_rows=2000, dim=32, n_queries=5, k=10,
                              trials=2, steps=1, device="cpu")
    rows = _rows(capsys)
    _check_rows(rows, ["retrieval_p50_2k_rows_q5",
                       "retrieval_p50_2k_rows_q5_int8"])
    assert rows[0]["index_bytes"] == 2000 * 32 * 2
    assert rows[1]["index_bytes"] == 2000 * 32 + 2000 * 4
    assert 0.8 <= rows[1]["recall_at_k_vs_bf16"] <= 1.0


def test_int8_capacity_row(capsys):
    extra.bench_int8_capacity(n_rows=3000, dim=32, n_queries=4, trials=2,
                              steps=1, device="cpu")
    rows = _rows(capsys)
    _check_rows(rows, ["int8_index_p50_0.003M_rows_q4"])
    assert 0.8 <= rows[0]["recall_at_k_vs_f32"] <= 1.0
    assert rows[0]["index_bytes_f32"] == 4 * 3000 * 32


def test_flash_sweep_rows(capsys):
    extra.bench_flash_sweep(batch=1, heads=2, head_dim=16, seq_lens=(32, 48),
                            steps=1, device="cpu")
    rows = _rows(capsys)
    _check_rows(rows, ["attention_flash_S32_bf16", "attention_plain_S32_bf16",
                       "attention_flash_S48_bf16",
                       "attention_plain_S48_bf16"])
    assert all(r["unit"] == "TFLOP/s" for r in rows)


def test_tower_rows(capsys):
    cfg = common.flagship_config(**SMALL)
    extra.bench_text_tower(batch=3, steps=1, device="cpu", cfg=cfg)
    extra.bench_u8_ingest(batch=2, frames=2, steps=1, device="cpu", cfg=cfg)
    rows = _rows(capsys)
    _check_rows(rows, ["text_embed_throughput_vitb32_bf16",
                       "video_embed_u8_ingest_vitb32_bf16_8f224"])


def test_train_step_timesformer_row(capsys):
    from cross_modal_video_engine_tpu_torch.models.timesformer import (
        TimeSformerConfig)
    cfg = TimeSformerConfig(num_frames=2, img_size=16, patch_size=8,
                            embed_dims=16, num_heads=2, num_layers=1,
                            drop_path_max=0.0)
    with torch.random.fork_rng(devices=[]):
        extra.bench_train_step_timesformer(batch=2, steps=1, device="cpu",
                                           cfg=cfg, num_classes=5)
    rows = _rows(capsys)
    _check_rows(rows, ["train_step_timesformer_divst_8x224_b2"])
    assert rows[0]["tflops_per_sec"] > 0


def test_train_step_slowfast_row(capsys):
    from cross_modal_video_engine_tpu_torch.models.resnet3d import (
        SlowFastConfig)
    cfg = SlowFastConfig(depth_blocks=(1, 1, 1, 1), alpha=4, beta_inv=4,
                         base_channels=8, fast_s2d_stem=True)
    with torch.random.fork_rng(devices=[]):
        extra.bench_train_step_slowfast(batch=2, frames=8, steps=1,
                                        device="cpu", cfg=cfg,
                                        num_classes=5, img=32)
    rows = _rows(capsys)
    _check_rows(rows, ["train_step_slowfast_r50_4x16_bf16_b2"])
    assert rows[0]["tflops_per_sec"] > 0 and rows[0]["step_ms"] > 0


def test_conv_flops_count_every_convolution():
    """forward_flops counts the s2d stem as the plain conv it equals, and
    a 1x1x1 conv by hand."""
    from cross_modal_video_engine_tpu_torch.models.resnet3d import (
        ResNet3D, ResNet3DConfig, forward_flops)
    kw = dict(stage_blocks=(1, 1, 1, 1), base_channels=8, conv1_kernel_t=5)
    x = torch.zeros(1, 4, 32, 32, 3)
    plain = forward_flops(ResNet3D(ResNet3DConfig(**kw), "cpu"), x)
    s2d = forward_flops(ResNet3D(ResNet3DConfig(**kw, s2d_stem=True), "cpu"),
                        x)
    assert plain == s2d > 0
    stem = 2.0 * (8 * 4 * 16 * 16) * (3 * 5 * 7 * 7)
    conv3 = 2.0 * (32 * 4 * 8 * 8) * 8        # layer1's 1x1x1 conv3
    assert plain > stem + conv3


def test_train_step_yolov5_rows(capsys):
    with torch.random.fork_rng(devices=[]):
        extra.bench_train_step_yolov5(batch=2, img=64, max_targets=4,
                                      steps=1, device="cpu", width=0.125)
        extra.bench_train_step_yolov5_seg(batch=2, img=64, max_targets=4,
                                          steps=1, device="cpu",
                                          width=0.125)
    rows = _rows(capsys)
    _check_rows(rows, ["train_step_yolov5s_64_bf16_b2",
                       "train_step_yolov5s_seg_64_bf16_b2"])
    assert all(r["step_ms"] > 0 for r in rows)


@pytest.mark.parametrize("attention", ["divided_space_time",
                                       "joint_space_time", "space_only"])
def test_timesformer_flops_count_the_products(attention):
    """The count against one made by hand for ViT-B/16 joint, and the
    divided count against the joint one plus its extra products."""
    from cross_modal_video_engine_tpu_torch.models.timesformer import (
        TimeSformerConfig)
    cfg = TimeSformerConfig(attention_type=attention)
    got = extra.timesformer_forward_flops(cfg, 2, 400)
    d, n = 768, 1 + 196 * 8
    embed, head = 8 * 196 * 768 * 768, 768 * 400
    joint_block = n * 12 * d * d + 2 * n * n * d
    if attention == "joint_space_time":
        assert got == 2 * 2 * (embed + 12 * joint_block + head)
    elif attention == "divided_space_time":
        temporal = 196 * 8 * 5 * d * d + 196 * 2 * 64 * d
        spatial = 8 * 197 * 4 * d * d + 8 * 2 * 197 ** 2 * d
        assert got == 2 * 2 * (embed + 12 * (temporal + spatial
                                             + n * 8 * d * d) + head)
    else:
        assert got == 2 * 2 * (embed + 12 * (8 * 197 * 12 * d * d
                                             + 8 * 2 * 197 ** 2 * d) + head)


def test_extra_main_takes_row_names(monkeypatch):
    ran = []
    monkeypatch.setattr(extra, "_BENCHES",
                        [(n, lambda n=n: ran.append(n))
                         for n, _ in extra._BENCHES])
    extra.main(["u8_ingest", "retrieval_p50"])
    assert ran == ["retrieval_p50", "u8_ingest"]          # in table order
    with pytest.raises(SystemExit, match="unknown"):
        extra.main(["flatten_tokens"])
    ran.clear()
    extra.main([])
    assert ran == [n for n, _ in extra._BENCHES]


def test_arms_share_weights_and_differ_in_flags():
    cfg = common.flagship_config(**SMALL)
    kernel, plain = common.clip_arms(cfg, "cpu")
    assert kernel.cfg.fused_attn and kernel.cfg.fused_mlp
    assert not (plain.cfg.fused_attn or plain.cfg.fused_mlp)
    assert dataclasses.replace(kernel.cfg, fused_attn=False,
                               fused_mlp=False) == plain.cfg
    a, b = kernel.state_dict(), plain.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not any(p.requires_grad for p in kernel.parameters())


def test_block_profile_names_the_kernels_phases():
    """bench/block_profile.py names the 16 BLK_MARK phases of
    csrc/block_sublayer.cu, and an instrumented build is keyed apart from
    the package's own."""
    import re
    from cross_modal_video_engine_tpu_torch.bench import block_profile as bp
    from cross_modal_video_engine_tpu_torch.ops import _build
    source = (_build.CSRC / "block_sublayer.cu").read_text()
    marks = {int(m) for m in re.findall(r"BLK_MARK\(\d, (\d+)\)", source)}
    assert marks == set(range(len(bp.PHASES))) and len(bp.PHASES) == 16
    assert "CMVE_BLK_THREADS" not in source
    sources = _build._sources()
    plain = _build._key(sources, _build.NVCC_FLAGS)
    assert plain == _build._key(sources, _build.NVCC_FLAGS)
    assert plain != _build._key(
        sources, (*_build.NVCC_FLAGS, "-DCMVE_BLK_PROFILE"))


def test_device_time_wants_a_device_for_a_closure():
    """A zero-argument closure names no device: the caller must, or a
    closure over card tensors would be timed on the host clock."""
    with pytest.raises(TypeError, match="device="):
        device_time(lambda: None, steps=1)
    assert device_time(lambda: None, steps=1, device="cpu") >= 0


@pytest.mark.parametrize("nseq,seq_len,blocks", [(3, 50, 3), (13, 10, 3),
                                                 (2, 64, 2)])
def test_block_weight_bytes_through_l2(nseq, seq_len, blocks):
    """bench/block_profile.py's L2 bytes of a layer: every thread block
    (64 rows of whole sequences, the last one short) streams all six
    weight matrices, 4 D^2 + 2 D hidden bf16."""
    from cross_modal_video_engine_tpu_torch.bench import block_profile
    d = 64
    x, params = block_ab.build_stack(nseq, seq_len, d, 1, device="cpu")
    flat = [*params[0][0], *params[0][1]]
    got = block_profile.weight_bytes_through_l2(x, flat, seq_len)
    assert got == blocks * 2 * (4 * d * d + 2 * d * 4 * d)
