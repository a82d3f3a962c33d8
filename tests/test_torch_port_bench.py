"""`python -m fusiondepth_torch.bench`, the port of bench.py: its command
line, one run of config 1 on the CPU at 64x96 (the card's run is the
bench's purpose; `--device cpu` exists for this test), and that it refuses
to run without a card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from fusiondepth_torch import bench

from test_torch_port_models import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_command_line_and_set_overrides():
    args = bench.parse_args([])
    assert (args.config, args.device, args.trials) == (3, "cuda:0", 5)
    assert args.trials >= 5 and args.set is None
    args = bench.parse_args(["--config", "5", "--set", "batch_size=2",
                             "--set", "no_ssim=true", "--set",
                             "pallas_warp_backend=gather", "--set",
                             "learning_rate=1e-3"])
    assert args.config == 5
    assert bench.parse_set(args.set) == {
        "batch_size": 2, "no_ssim": True, "pallas_warp_backend": "gather",
        "learning_rate": 1e-3}
    with pytest.raises(SystemExit):
        bench.parse_args(["--config", "7"])
    assert bench.peak_fp32_tflops("NVIDIA H100 80GB HBM3") == 66.9
    assert bench.peak_fp32_tflops("NVIDIA H100 PCIe") == 51.2
    assert bench.peak_fp32_tflops("cpu") is None
    assert bench.peak_tflops("NVIDIA H100 80GB HBM3", "bfloat16") == 989.0
    assert bench.peak_tflops("NVIDIA H100 80GB HBM3", "float32") == 66.9
    assert bench.peak_tflops("NVIDIA H100 PCIe", "bfloat16") == 756.0


def test_config1_prints_one_json_line_on_the_cpu(capsys):
    assert bench.main(["--config", "1", "--device", "cpu", "--trials", "2",
                       "--set", "height=64", "--set", "width=96", "--set",
                       "weights_init=scratch"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    r = json.loads(lines[0])
    assert r["metric"] == "forward_fps_r18_640x192_b1"
    assert r["unit"] == "fps" and r["value"] > 0
    assert r["vs_baseline"] == pytest.approx(r["value"] / 30.0)
    ms = r["step_ms"]
    assert 0 < ms["min"] <= ms["median"] <= ms["max"]
    assert r["value"] == pytest.approx(1e3 / ms["median"])
    assert r["trials"] == 2 and r["flops_per_step"] > 0
    assert r["weights_init"] == "random" and r["device_kind"] == "cpu"


def test_config1_bf16_names_its_dtype(capsys):
    """--set compute_dtype=bfloat16 runs the bf16 forward (no new flag);
    the line says which dtype its MFU is against."""
    assert bench.main(["--config", "1", "--device", "cpu", "--trials", "1",
                       "--set", "height=64", "--set", "width=96", "--set",
                       "weights_init=scratch", "--set",
                       "compute_dtype=bfloat16"]) == 0
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r["compute_dtype"] == "bfloat16" and r["value"] > 0
    assert r["flops_per_step"] > 0 and "mfu" not in r  # no CPU peak


def test_bench_without_a_card_raises():
    assert not torch.cuda.is_available()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-m", "fusiondepth_torch.bench",
                        "--config", "1"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "CUDA card" in r.stderr
