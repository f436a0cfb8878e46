"""``grl_tpu_torch.tools.profile_train_step`` on the CPU.

The report's arithmetic on a canned Chrome trace whose kernels, launches,
correlation ids and flops are known (categories, the top rows, the link
from each kernel to the op that launched it, the roofline's rates), a
tiny capture on the CPU read back with ``--report-only``, and the
descriptor program the tool traces against grl_tpu's
(``tools/profile_train_step.py:85-88``) on the same weights. The tool runs
in its own process session under a timeout, past which it is killed and
the test fails.
"""

import json
import os
import os.path as osp
import signal
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grl_tpu_torch.tools import profile_train_step as P
from grl_tpu_torch.utils.profiling import PEAK_BF16_OPS, PEAK_BYTES, PEAK_FP32_OPS

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
TIMEOUT = 240


def tool(*argv):
    proc = subprocess.Popen([sys.executable, "-m", "grl_tpu_torch.tools.profile_train_step", *argv], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, start_new_session=True,
                            env={**os.environ, "OMP_NUM_THREADS": "2"})
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        pytest.fail(f"profile_train_step did not finish in {TIMEOUT} s:\n{out[-3000:]}\n{err[-3000:]}")
    assert proc.returncode == 0, f"{out[-3000:]}\n{err[-3000:]}"
    return out


def op(name, ts, dur, ext, tid=1, **args):
    return {"ph": "X", "cat": "cpu_op", "name": name, "pid": 1, "tid": tid, "ts": ts, "dur": dur,
            "args": {"External id": ext, **args}}


def launch(ts, corr, tid=1, cat="cuda_runtime", name="cudaLaunchKernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts, "dur": 2,
            "args": {"External id": 0, "correlation": corr}}


def kernel(name, dur, corr, ext=0, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": 1000 + corr, "dur": dur,
            "args": {"External id": ext, "correlation": corr, "stream": 7}}


CONV_IN, CONV_W = [2, 3, 16, 16], [8, 3, 3, 3]
CANNED = [
    # forward on thread 1: a convolution chain, a product, an in-place add
    op("aten::conv2d", 0, 100, 1, flops=2e9, **{
        "Input Dims": [CONV_IN, CONV_W, [], [], [], [], []],
        "Input type": ["c10::BFloat16", "c10::BFloat16", "", "ScalarList", "ScalarList", "ScalarList", "Scalar"],
        "Concrete Inputs": ["", "", "", "[1, 1]", "[1, 1]", "[1, 1]", "1"]}),
    op("aten::convolution", 10, 80, 2),
    op("aten::cudnn_convolution", 20, 60, 3),
    op("aten::mm", 200, 50, 4, flops=1e9, **{"Input Dims": [[64, 32], [32, 16]], "Input type": ["float", "float"]}),
    op("aten::add_", 300, 20, 5),
    # backward on thread 2
    op("autograd::engine::evaluate_function: ConvolutionBackward0", 400, 100, 6, tid=2),
    op("ConvolutionBackward0", 405, 90, 7, tid=2),
    op("aten::convolution_backward", 410, 80, 8, tid=2, **{
        "Input Dims": [[2, 8, 16, 16], CONV_IN, CONV_W, [], [], [], [], [], [], [], []],
        "Input type": ["c10::BFloat16"] * 3 + ["ScalarList"] * 8}),
    launch(30, 100),
    launch(40, 101, cat="cuda_driver", name="cuLaunchKernelEx"),
    launch(210, 102),
    launch(305, 103),
    launch(310, 106, name="cudaMemcpyAsync"),
    launch(420, 104, tid=2),
    launch(430, 105, tid=2),
    kernel("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64", 50, 100),
    kernel("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16, __nv_bfloat16, float>", 10, 101),
    kernel("nvjet_tst_256x128_64x4_1x2_h_ssched_bz_coopA_TNT", 20, 102),
    kernel("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>", 5, 103),
    kernel("Memcpy DtoD (Device -> Device)", 4, 106, cat="gpu_memcpy"),
    kernel("sm80_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize64x64x64", 30, 104),
    kernel("void wgrad_alg0_engine_NHWC<__nv_bfloat16, 128, 5, 5, 3, 3, 3, false, 512>", 25, 105),
    # no launch event: linked through its External id, or to no op at all
    kernel("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::func_wrapper<float>>>",
           3, 998, ext=5),
    kernel("(anonymous namespace)::minplus_kernel(CUtensorMap_st, CUtensorMap_st, float*, int)", 7, 999),
    # a GPU-side annotation spans kernels and is no kernel of its own
    {"ph": "X", "cat": "gpu_user_annotation", "name": "Optimizer.step#SGD.step", "pid": 0, "tid": 7, "ts": 1000,
     "dur": 1000, "args": {"External id": 9}},
]


@pytest.fixture
def canned(tmp_path):
    meta = {"program": "train", "batch": 16, "steps": 2, "seq_len": 8, "frame": [256, 128], "device": "cuda:0",
            "compute_dtype": "bfloat16", "nvidia_smi": "NVIDIA H100 80GB HBM3, 700.00 W"}
    with open(tmp_path / "trace.json", "w") as f:
        json.dump({"traceEvents": CANNED, "grl_profile": meta}, f)
    return tmp_path


def test_kernel_categories_and_the_link_to_each_op(canned):
    trace = P.Trace(str(canned / "trace.json"))
    assert trace.on_device and trace.steps == 2 and trace.linked == 8 and len(trace.device) == 9
    total, by_cat, by_name = P.kernel_stats(trace)
    assert total == 154.0
    assert by_cat == {"convolution": [115.0, 4], "gemm": [20.0, 1], "elementwise": [5.0, 1],
                      "copy/memset": [4.0, 1], "reduction": [3.0, 1], "minplus": [7.0, 1]}
    assert sum(us for us, _ in by_cat.values()) == total
    _, _, by_op = P.kernel_stats(trace, P._op_key)
    assert {k: v[0] for k, v in by_op.items()} == {
        "aten::cudnn_convolution": 60.0, "aten::mm": 20.0, "aten::add_": 12.0,
        "aten::convolution_backward": 55.0, "(no op)": 7.0}
    ops = {o.name: o for o in trace.ops}
    assert ops["aten::conv2d"].kernel_us == 60.0 and ops["aten::convolution"].parent is ops["aten::conv2d"]
    assert ops["autograd::engine::evaluate_function: ConvolutionBackward0"].kernel_us == 55.0


def test_roofline_rows_are_exact(canned):
    trace = P.Trace(str(canned / "trace.json"))
    rows = {r["name"]: r for r in P.roofline(trace, "convolution")}
    # cudnn_convolution matches by name and is raised to conv2d (no other
    # kernel in between); the backward chain to its autograd wrapper
    assert sorted(rows) == ["aten::conv2d", "autograd::engine::evaluate_function: ConvolutionBackward0"]
    fwd = rows["aten::conv2d"]
    assert fwd["occ"] == 1 and fwd["ms_step"] == pytest.approx(0.030, rel=1e-12)
    assert fwd["tflops_s"] == pytest.approx(2e9 / 60e-6 / 1e12, rel=1e-12)
    assert fwd["pct_ops"] == pytest.approx(100 * 2e9 / 60e-6 / PEAK_BF16_OPS, rel=1e-12)
    conv_bytes = 2 * (2 * 3 * 16 * 16 + 8 * 3 * 3 * 3 + 2 * 8 * 16 * 16)  # input, weight, output in bf16
    assert fwd["gbytes_s"] == pytest.approx(conv_bytes / 60e-6 / 1e9, rel=1e-12)
    assert fwd["pct_bytes"] == pytest.approx(100 * conv_bytes / 60e-6 / PEAK_BYTES, rel=1e-12)
    assert fwd["bound"] == "operations"
    bwd = rows["autograd::engine::evaluate_function: ConvolutionBackward0"]
    assert bwd["tflop"] == 0 and bwd["ms_step"] == pytest.approx(0.0275, rel=1e-12)
    # grad output read, input and weight read and their gradients written
    bwd_bytes = 2 * (2 * 8 * 16 * 16 + 2 * (2 * 3 * 16 * 16 + 8 * 3 * 3 * 3))
    assert bwd["gbytes_s"] == pytest.approx(bwd_bytes / 55e-6 / 1e9, rel=1e-12)
    (mm,) = P.roofline(trace, "gemm")  # by its kernels' category
    assert mm["name"] == "aten::mm" and mm["dtype"] == "float"
    assert mm["tflops_s"] == pytest.approx(50.0, rel=1e-12)
    assert mm["pct_ops"] == pytest.approx(100 * 50e12 / PEAK_FP32_OPS, rel=1e-12)
    assert mm["gbytes_s"] == pytest.approx(4 * (64 * 32 + 32 * 16 + 64 * 16) / 20e-6 / 1e9, rel=1e-12)


def test_report_only_prints_the_canned_tables(canned):
    out = tool("--report-only", "--logdir", str(canned), "--roofline", "convolution", "--top", "3")
    lines = out.splitlines()
    assert lines[0].startswith("program train: batch 16, 2 traced steps")
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in lines[0]
    assert "bfloat16" in lines[0] and "8 of 9 device events linked" in lines[1]
    assert "total kernel self time: 0.154 ms (across 2 traced steps)" in out
    assert any(ln.split()[:3] == ["convolution", "0.115", "74.7"] for ln in lines)
    top = lines[lines.index("top 3 kernels by self time:") + 1:][:3]
    assert [ln.split()[0] for ln in top] == ["0.050", "0.030", "0.025"]
    assert "roofline /convolution/: 2 matching ops" in out
    ops_out = tool("--report-only", "--logdir", str(canned), "--tool", "op_stats")
    assert "top 25 ops by self time:" in ops_out and "aten::cudnn_convolution" in ops_out
    assert tool("--tool", "list").strip() == str(list(P.TOOLS))


@pytest.mark.parametrize("program,batch", [("train", 4), ("describe", 2)])
def test_a_tiny_cpu_capture_reads_back(tmp_path, program, batch):
    """The CLIs' tiny trunk at 2 frames of 64x32 (the train program needs
    two pairs: its verification BatchNorm needs more than one value)."""
    logdir = str(tmp_path / program)
    argv = ["--program", program, "--batch", str(batch), "--steps", "1", "--seq_len", "2", "--height", "64",
            "--width", "32", "--device", "cpu", "--tiny", "--logdir", logdir, "--roofline", "conv"]
    out = tool(*argv)
    assert tool(*argv, "--report-only") == out
    assert "a CPU trace" in out and "convolution" in out
    with open(osp.join(logdir, "trace.json")) as f:
        trace = json.load(f)
    meta = trace["grl_profile"]
    assert meta["program"] == program and meta["batch"] == batch and meta["compute_dtype"] == "bfloat16"
    assert meta["flops_ops"] == meta["flops_ops_matched"] > 0
    assert any(e["name"] == "aten::conv2d" and e["args"].get("flops", 0) > 0 for e in trace["traceEvents"])


def test_describe_program_is_grl_tpu_s_concatenation():
    """The port's traced program and grl_tpu's (normalize, CNN, attention
    pooling, concat of x_uncorr, pooled and the mean over t of x_corr) on
    grl_tpu's tiny fp32 weights, converted."""
    from grl_tpu.cli.train import build_models as j_build
    from grl_tpu.data.transforms import normalize as j_normalize
    from grl_tpu_torch.utils import state_dict_from_jax

    jcnn, jsia, _ = j_build(SimpleNamespace(bf16=False, use_flow=False, arch2="siamese"), tiny=True)
    (cp, cs), (sp, ss) = jcnn.init(jax.random.PRNGKey(0)), jsia.init(jax.random.PRNGKey(1))

    @jax.jit
    def describe(cp, cs, sp, ss, clips_u8):
        (x_uncorr, x_corr), _ = jcnn.apply(cp, cs, j_normalize(clips_u8), training=False)
        pooled, _ = jsia.self_attention(sp, ss, x_corr, training=False)
        return jnp.concatenate([x_uncorr, pooled, jnp.mean(x_corr, axis=1)], axis=1)

    cnn, sia, program = P.describe_program("cpu", tiny=True, compute_dtype="fp32")
    for mod, p, s in ((cnn, cp, cs), (sia, sp, ss)):
        mod.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s), mod),
                            strict=True)
    clips = np.random.RandomState(0).randint(0, 256, (2, 2, 64, 32, 3)).astype(np.uint8)
    want = np.asarray(describe(cp, cs, sp, ss, jnp.asarray(clips)))
    with torch.no_grad():
        got = program(torch.from_numpy(clips)).numpy()
    assert got.shape == want.shape == (2, 3 * cnn.num_feat) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
