"""bench/kernel_profile.py at a tiny size on the CPU: the sweep's rows (on
the CPU they time the plain versions and carry no device metric's name),
the names of its parts, and that every ablation still finds the lines of
csrc/flash_attention.cu it cuts out."""

import json
from pathlib import Path

import pytest

from cross_modal_video_engine_tpu_torch.bench import kernel_profile as kp


def _rows(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def test_gemm_sweep_rows(capsys):
    kp.bench_gemm(shapes=((37, 24, 40, "gelu", 1), (9, 16, 8, "bias", 3),
                          (20, 40, 24, "residual", 1)),
                  steps=1, device="cpu")
    rows = _rows(capsys)
    assert [r["metric"] for r in rows] == [
        "gemm_gelu_M37_K24_N40_x1_bf16", "gemm_bias_M9_K16_N8_x3_bf16",
        "gemm_residual_M20_K40_N24_x1_bf16"]
    for r in rows:
        assert r["unit"] == "ms/cpu" and r["device"] == "cpu"
        assert r["value"] > 0 and r["f_linear_ms"] > 0 and r["tflops"] > 0


def test_flash_sweep_rows(capsys):
    kp.bench_flash(shapes=((1, 2, 33, 16, False), (1, 1, 40, 64, True)),
                   steps=1, device="cpu")
    rows = _rows(capsys)
    assert [r["metric"] for r in rows] == ["flash_B1_H2_S33_D16_bf16",
                                           "flash_B1_H1_S40_D64_causal_bf16"]
    assert all(r["unit"] == "ms/cpu" and r["sdpa_ms"] > 0 for r in rows)


def test_main_names_its_parts():
    with pytest.raises(SystemExit, match="unknown part"):
        kp.main(["sweep", "nonsense"])
    with pytest.raises(SystemExit, match="need the card"):
        kp.profile_arms(device="cpu")


@pytest.mark.parametrize("name", list(kp.ABLATIONS))
def test_ablation_edits_match_the_source(name):
    src = (Path(kp.__file__).resolve().parents[1] / "csrc"
           / "flash_attention.cu").read_text()
    for old, new in kp.ABLATIONS[name]:
        assert src.count(old) == 1 and old != new
