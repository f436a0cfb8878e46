"""The port's probe and sweep tools (``grl_tpu_torch/tools``: ``probe_bandwidth``,
``probe_int8``, ``sweep_compiler_options``, ``sweep_train_compiler_options``)
on the CPU.

Each ``main`` runs here with ``--device cpu``, its module's sizes cut small
where the full ones would not fit a CPU test (the models stay full width),
and prints its card line, one line per reading and a JSON line; the
sweeps' variants that run in processes of their own start them here too.
Each refuses to start without a card when ``--device`` is left at its
default. The int8 product and the im2col convolution of ``probe_int8`` are
held exact against numpy's int64 arithmetic.
"""

import importlib
import json

import numpy as np
import pytest
import torch

from grl_tpu_torch import precision_flags, set_precision_flags
from grl_tpu_torch.tools import probe_bandwidth, probe_int8, sweep_compiler_options, sweep_train_compiler_options

TOOLS = ("probe_bandwidth", "probe_int8", "sweep_compiler_options", "sweep_train_compiler_options")
# 64x32 frames: at 32x16, layer3's stride-2 conv sees 4x2 pixels, where
# torch's CPU bf16 convolution answers differently after the modules went
# to channels_last and back (the sweep's check catches it: a CPU library
# fault, not the tool's)
SMALL_CLIPS = dict(SEQ_LEN=2, FRAME=(64, 32), WINDOWS=1, WARM=1)


@pytest.fixture
def run_main(monkeypatch, capsys):
    """``main(["--device", "cpu"])`` of a tool with ``sizes`` set on its
    module; its output lines. The precision flags that ``main`` sets are
    put back after the test. The test and its child processes run on two
    threads each: they share the host with the other test workers, and a
    CPU's bf16 sums change with the number of threads."""
    flags, threads = precision_flags(), torch.get_num_threads()
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    torch.set_num_threads(2)

    def run(module, **sizes):
        for name, value in sizes.items():
            monkeypatch.setattr(module, name, value)
        module.main(["--device", "cpu"])
        return capsys.readouterr().out.strip().splitlines()

    yield run
    set_precision_flags(flags)
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", TOOLS)
def test_tool_refuses_to_start_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        importlib.import_module(f"grl_tpu_torch.tools.{name}").main([])


def test_probe_bandwidth_prints_its_lines(run_main):
    """grl_tpu's sizes as they are: the copies go host to host."""
    lines = run_main(probe_bandwidth)
    assert lines[0] == "card: cpu: no card"
    report = json.loads(lines[-1])
    # host to host: pageable only, each size both ways
    assert sorted(report["copies"]) == sorted(f"{size}_{d}_pageable" for size in
                                              ("16MiB", "train_batch_16", "serve_chunk_32") for d in ("h2d", "d2h"))
    assert report["copies"]["train_batch_16_h2d_pageable"]["bytes"] == 16 * 8 * 256 * 128 * 3
    assert report["copies"]["serve_chunk_32_d2h_pageable"]["bytes"] == 32 * 8 * 256 * 128 * 3
    assert all(c["GB_per_s"] > 0 for c in report["copies"].values())
    assert report["per_dispatch_ms"] > 0 and report["item_ms"] > 0
    assert any(line.startswith("per-dispatch:") for line in lines)
    assert any(line.startswith("item round trip:") for line in lines)


def test_int8_product_and_im2col_conv_are_exact_against_numpy():
    """``torch._int_mm`` at 64x64 and the probe's im2col convolution
    (nine wrapped shifts of NHWC int8 frames times HWIO int8 weights)
    against numpy int64. torch has ``torch._int_mm`` on the CPU, so the
    products are held and not a rejection line."""
    rng = np.random.RandomState(3)
    a = rng.randint(-127, 127, (64, 64)).astype(np.int8)
    b = rng.randint(-127, 127, (64, 64)).astype(np.int8)
    got = torch._int_mm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.int64), a.astype(np.int64) @ b.astype(np.int64))

    x = rng.randint(-127, 127, (2, 4, 8, 16)).astype(np.int8)  # frames, h, w, channels: 64 rows
    w = rng.randint(-127, 127, (3, 3, 16, 64)).astype(np.int8)
    got = torch._int_mm(probe_int8.im2col(torch.from_numpy(x)), torch.from_numpy(w).reshape(9 * 16, 64))
    want = np.zeros((2, 4, 8, 64), np.int64)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            shifted = np.roll(x, (-dy, -dx), axis=(1, 2)).astype(np.int64)
            want += shifted @ w[dy + 1, dx + 1].astype(np.int64)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want.reshape(64, 64))


def test_probe_int8_prints_its_lines(run_main):
    lines = run_main(probe_int8, N=64, CONV=(2, 16, 4, 4, 64), ITERS=2)
    assert lines[0] == "card: cpu: no card"
    assert len(lines) == 9
    report = json.loads(lines[-1])
    assert report["n"] == 64 and report["conv"] == [2, 16, 4, 4, 64]
    int8 = ("matmul_int8", "matmul_int8_b_colmajor", "im2col_int8", "im2col_int8_w_colmajor")
    for key in int8:
        assert report[key]["exact"] is True and report[key]["out_dtype"] == "int32"
    for key in (*int8, "matmul_bf16", "conv_bf16"):
        assert report[key]["ms"] > 0 and report[key]["peak_share"] is None  # no data-sheet peak on the CPU
    # the int8 conv is a result either way: rejected, or timed with its dtype and exactness
    conv = report["conv_int8"]
    assert ("rejected" in conv and "REJECTED" in lines[4]) or ("exact" in conv and "out_dtype" in conv)


def test_sweep_compiler_options_prints_its_lines(run_main):
    """Every variant, the two that autotune in processes of their own:
    one window of one call each, every descriptor within 1e-2 of the
    default's."""
    lines = run_main(sweep_compiler_options, BATCH=3, ITERS=1, **SMALL_CLIPS)
    report = json.loads(lines[-1])
    variants = report["variants"]
    assert list(variants) == ["default", "cudnn_benchmark", "channels_last", "channels_last_benchmark",
                              "cuda_graph", "default2"]
    assert variants["cuda_graph"] == {"skipped": "CUDA graphs need a card"}
    for name, row in variants.items():
        if name != "cuda_graph":
            assert len(row["clips_per_s"]) == 1 and row["clips_per_s"][0] > 0 and row["first_call_s"] > 0
            assert row["max_abs_diff"] <= 1e-2
    assert variants["default2"]["max_abs_diff"] == 0
    own = [line.split(":")[0] for line in lines if "own process" in line]
    assert own == ["cudnn_benchmark", "channels_last_benchmark"]
    assert report["dtype"] == "bfloat16" and report["batch"] == 3 and report["frame"] == [64, 32]


def test_sweep_train_compiler_options_prints_its_lines(run_main):
    """Every variant, the two that autotune and the deterministic one in
    processes of their own: one window of one step each, the bf16
    variants' first-step losses equal on the CPU (the same kernels), the
    fp32 rows' losses equal."""
    lines = run_main(sweep_train_compiler_options, BATCH=4, STEPS=1, **SMALL_CLIPS)
    report = json.loads(lines[-1])
    variants = report["variants"]
    assert list(variants) == ["default", "cudnn_benchmark", "channels_last", "channels_last_benchmark", "default2",
                              "fp32", "fp32_deterministic"]
    for row in variants.values():
        assert len(row["ms_per_step"]) == 1 and row["ms_per_step"][0] > 0 and np.isfinite(row["loss"])
    assert len({variants[k]["loss"] for k in ("default", "cudnn_benchmark", "default2")}) == 1
    assert abs(variants["channels_last"]["loss"] - variants["default"]["loss"]) <= 1e-2
    assert variants["fp32_deterministic"]["loss"] == variants["fp32"]["loss"]
    assert variants["fp32_deterministic"]["nondeterministic_ops"] == []  # none on the CPU
    assert "nondeterministic_ops" not in variants["fp32"]
    own = [line.split(":")[0] for line in lines if "own process" in line]
    assert own == ["cudnn_benchmark", "channels_last_benchmark", "fp32_deterministic"]
    assert report["num_classes"] == 625 and report["batch"] == 4
