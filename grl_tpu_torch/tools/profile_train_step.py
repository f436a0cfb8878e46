"""Trace a hot program under ``torch.profiler`` and print its device time
by kernel category, by op, or as a roofline (counterpart of
``tools/profile_train_step.py``, which reads xprof's tables).

``--program train`` (default) traces the bf16 training step: the full
``resnet50_grl`` + ``Siamese(2048, 512)`` + ``SiameseVideo(2048)`` with
``compute_dtype=torch.bfloat16``, SGD, 625 classes, ``make_train_step``,
float clips (batch, seq_len, 256, 128, 3) from ``RandomState(0)`` and ids
in pairs, lr 1e-3: one warm step, then ``--steps`` traced steps.
``--program describe`` traces the descriptor program (bf16 modules, uint8
clips through ``engine/evaluator.py::make_descriptor_fn``: normalize, CNN,
attention pooling, the 6144-d concatenation), ``--batch`` clips a call.

The trace (CPU and CUDA activities, shapes recorded, the profiler's flop
counts) is written to ``LOGDIR/trace.json`` in Chrome's format, with the
run's description under ``"grl_profile"``; ``--report-only`` reads that
file back and needs no card. ``--tool``:

- ``kernel_stats`` (default): total kernel time over the traced steps, then
  time, share and count by kernel category (``CATEGORIES``, from the CUDA
  kernels' names), then the top kernels;
- ``op_stats``: the same by the op that launched each kernel (the innermost
  op around its launch);
- ``list``: the tool names.

``--roofline REGEX`` then prints one row per op whose name, or the category
of whose kernels, matches: ms per step, occurrences, TFLOP/s from the
profiler's flops, GB/s from the recorded input shapes and the output
shapes they imply (the least traffic the op can have), the share of the
card's peak (``utils.profiling``: the H100 data sheet) and which peak
binds. An op's time is the sum of the kernels launched inside it, nested
ops included; an op inside another matching op is counted in that one.
(grl_tpu prints the roofline in place of the tool's table; this prints
both.) A trace taken on the CPU has no kernels: there each op's CPU self
time stands in for them, and the header says so.

    python3 -m grl_tpu_torch.tools.profile_train_step --batch 16 --steps 3
    python3 -m grl_tpu_torch.tools.profile_train_step --program describe --batch 96 --roofline convolution
    python3 -m grl_tpu_torch.tools.profile_train_step --report-only --logdir DIR --tool op_stats
    python3 -m grl_tpu_torch.tools.profile_train_step --device cpu --tiny --batch 2 --seq_len 2 \\
        --height 64 --width 32 --steps 1

It runs on the card by default; ``--device cpu`` (with ``--tiny`` and a
small frame) is for the tests.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import os.path as osp
import re
import subprocess
import sys
import tempfile
from collections import defaultdict

import numpy as np

from ..utils.profiling import PEAK_BF16_OPS, PEAK_BYTES, PEAK_FP32_OPS

TOOLS = ("kernel_stats", "op_stats", "list")
# kernel category by name, first match wins; CUDA kernel names first, then
# the aten names that a CPU trace's ops carry
CATEGORIES = [
    ("minplus", r"minplus"),
    ("normalization", r"batch_?norm|bn_fw|bn_bw|layer_norm|group_norm"),
    ("convolution", r"conv|fprop|dgrad|wgrad|implicit_gemm|nchwToNhwc|nhwcToNchw|winograd|fft"
                    r"|pointwise_mult_and_sum_complex|im2col|col2im"),
    ("gemm", r"gemm|gemv|nvjet|cublas|cutlass|splitKreduce|matmul|::(mm|addmm|bmm|baddbmm|linear)\b"),
    ("softmax", r"softmax"),
    ("reduction", r"reduce|::(sum|mean|amax|amin|max|min|norm|var|std|prod|argmax|argmin)\b"),
    ("copy/memset", r"copy|memcpy|memset|fill|CatArray|::(cat|stack|clone|contiguous|to|_to_copy|zero_)\b"),
    ("elementwise", r"elementwise|pointwise|vectorized|Functor|multi_tensor_apply|::(add|sub|mul|div|addcmul|addcdiv"
                    r"|sigmoid|relu|threshold|exp|log|pow|sqrt|rsqrt|neg|clamp|where|lerp|foreach)\w*\b"),
]
_CATEGORY_RX = [(name, re.compile(rx, re.I)) for name, rx in CATEGORIES]
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
DTYPE_BYTES = {"float": 4, "c10::BFloat16": 2, "c10::Half": 2, "double": 8, "long int": 8, "int": 4,
               "short int": 2, "signed char": 1, "unsigned char": 1, "bool": 1}
# ops whose arguments 3, 4 and 5 are stride, padding and dilation
CONV_OPS = ("aten::conv2d", "aten::convolution", "aten::_convolution")


def category(name):
    for cat, rx in _CATEGORY_RX:
        if rx.search(name):
            return cat
    return "other"


# --- capture -----------------------------------------------------------------

def build_models(device, tiny=False, compute_dtype="bf16"):
    """``cli.train``'s models (the full width, or ``tiny``'s trunk) with
    ``compute_dtype`` (``"bf16"`` or ``"fp32"``), seed 0, on ``device``."""
    from ..cli.train import build_models as cli_models

    args = argparse.Namespace(bf16=compute_dtype == "bf16", seed=0, arch2="siamese", use_flow=False)
    return tuple(m.to(device) for m in cli_models(args, tiny=tiny))


def describe_program(device, tiny=False, compute_dtype="bf16"):
    """``(cnn, siamese, describe)``: the modules in eval mode and the
    descriptor program the tool traces (``make_descriptor_fn``)."""
    from ..engine import make_descriptor_fn

    cnn, sia, _ = build_models(device, tiny, compute_dtype)
    cnn.eval()
    sia.eval()
    return cnn, sia, make_descriptor_fn(cnn, sia)


def smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def traced(logdir, meta, run):
    """Run ``run()`` under ``torch.profiler`` (CPU, and CUDA on a card;
    shapes and flops recorded) and write ``logdir/trace.json`` with each
    op's profiler flops in its ``args`` and ``meta`` under
    ``"grl_profile"``; returns the path."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(meta["device"]).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        meta["device_name"] = torch.cuda.get_device_name(torch.device(meta["device"]))
        meta["nvidia_smi"] = smi_line()
    meta["torch"] = torch.__version__
    os.makedirs(logdir, exist_ok=True)
    path = osp.join(logdir, "trace.json")
    with profile(activities=activities, record_shapes=True, with_flops=True) as prof:
        run()
    prof.export_chrome_trace(path)
    # the Chrome export drops the flop counts: put each op's back by its id
    flops = {e.id: (e.name, e.flops) for e in prof.events() if e.flops}
    with open(path) as f:
        trace = json.load(f)
    matched = 0
    for ev in trace["traceEvents"]:
        if ev.get("cat") == "cpu_op":
            name, n = flops.get(ev.get("args", {}).get("External id"), (None, 0))
            if name == ev["name"]:
                ev["args"]["flops"] = n
                matched += 1
    meta["flops_ops"], meta["flops_ops_matched"] = len(flops), matched
    trace["grl_profile"] = meta
    with open(path, "w") as f:
        json.dump(trace, f)
    return path


def capture(batch, steps, seq_len, logdir, device="cuda", tiny=False, frame=(256, 128)):
    """Trace ``steps`` bf16 training steps after one warm step."""
    import torch

    from .. import resolve_device
    from ..engine import init_train_state, make_train_step

    device = str(resolve_device(device))
    cnn, sia, unc = build_models(device, tiny)
    state = init_train_state(cnn, sia, unc, 625, num_feat=cnn.num_feat, device=device)
    step = make_train_step(device=device)
    rng = np.random.RandomState(0)
    clips = torch.from_numpy(rng.rand(batch, seq_len, *frame, 3).astype(np.float32)).to(device)
    pids = np.repeat(np.arange(batch // 2) % 625, 2).astype(np.int64)
    step(state, clips, pids, 1e-3)
    sync(device)  # where grl_tpu reads the loss back

    def run():
        for _ in range(steps):
            step(state, clips, pids, 1e-3)
        sync(device)

    meta = dict(program="train", batch=batch, steps=steps, seq_len=seq_len, frame=list(frame), device=device,
                tiny=tiny, compute_dtype="bfloat16")
    return traced(logdir, meta, run)


def capture_describe(batch, steps, seq_len, logdir, device="cuda", tiny=False, frame=(256, 128)):
    """Trace ``steps`` calls of the bf16 descriptor program on ``batch``
    uint8 clips, summed into one value read at the end."""
    import torch

    from .. import resolve_device

    device = str(resolve_device(device))
    _, _, describe = describe_program(device, tiny)
    clips = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (batch, seq_len, *frame, 3), np.uint8))
    clips = clips.to(device)
    with torch.no_grad():
        float(describe(clips).sum())  # warm, and a sync

        def run():
            acc = torch.zeros((), device=device)
            for _ in range(steps):
                acc = acc + describe(clips).sum()
            float(acc)

        meta = dict(program="describe", batch=batch, steps=steps, seq_len=seq_len, frame=list(frame),
                    device=device, tiny=tiny, compute_dtype="bfloat16")
        return traced(logdir, meta, run)


# --- the trace ---------------------------------------------------------------

class Op:
    __slots__ = ("name", "ts", "end", "tid", "args", "parent", "kernel_us", "by_cat")

    def __init__(self, ev):
        self.name, self.ts, self.tid = ev["name"], float(ev["ts"]), ev.get("tid")
        self.end = self.ts + float(ev.get("dur", 0))
        self.args = ev.get("args", {})
        self.parent = None
        self.kernel_us = 0.0  # kernels launched inside it, nested ops included
        self.by_cat = defaultdict(float)


class Trace:
    """A Chrome trace of ``torch.profiler``: its ops (``cpu_op`` events, nested
    per thread), its device events (kernels, copies, memsets) and each device
    event's op, the innermost op around the launch whose correlation id it
    carries (or, failing that, the op of its ``External id``). A trace with
    no device events (a CPU capture) gets one stand-in event per op, its
    CPU self time."""

    def __init__(self, path):
        with open(path) as f:
            raw = json.load(f)
        self.meta = raw.get("grl_profile", {})
        events = raw["traceEvents"]
        self.ops = [Op(e) for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
        self._nest()
        by_id = {op.args.get("External id"): op for op in self.ops}
        launches = {e["args"]["correlation"]: e for e in events
                    if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
        self.device = []  # (name, us, category, op or None)
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            args = e.get("args", {})
            launch = launches.get(args.get("correlation"))
            op = self.op_at(launch.get("tid"), float(launch["ts"])) if launch else by_id.get(args.get("External id"))
            name = e["name"]
            self.device.append((name, float(e.get("dur", 0)), "copy/memset" if e["cat"] != "kernel" else category(name),
                                op))
        self.on_device = bool(self.device)
        if not self.on_device:
            child_us = defaultdict(float)
            for op in self.ops:
                if op.parent is not None:
                    child_us[id(op.parent)] += op.end - op.ts
            self.device = [(op.name, max(op.end - op.ts - child_us[id(op)], 0.0), category(op.name), op)
                           for op in self.ops]
        for _name, us, cat, op in self.device:
            while op is not None:
                op.kernel_us += us
                op.by_cat[cat] += us
                op = op.parent

    def _nest(self):
        self._starts = {}
        by_tid = defaultdict(list)
        for op in self.ops:
            by_tid[op.tid].append(op)
        for tid, ops in by_tid.items():
            ops.sort(key=lambda o: (o.ts, -o.end))
            stack = []
            for op in ops:
                while stack and op.ts >= stack[-1].end:
                    stack.pop()
                op.parent = stack[-1] if stack else None
                stack.append(op)
            self._starts[tid] = ([o.ts for o in ops], ops)

    def op_at(self, tid, ts):
        """The innermost op of thread ``tid`` whose span holds ``ts``."""
        starts, ops = self._starts.get(tid, ((), ()))
        i = bisect.bisect_right(starts, ts) - 1
        op = ops[i] if i >= 0 else None
        while op is not None and not op.ts <= ts <= op.end:
            op = op.parent
        return op

    @property
    def linked(self):
        return sum(1 for *_, op in self.device if op is not None)

    @property
    def steps(self):
        return int(self.meta.get("steps") or 1)


# --- the tables --------------------------------------------------------------

def _kernel_key(name, cat, op):
    return name


def _op_key(name, cat, op):
    return op.name if op is not None else "(no op)"


def kernel_stats(trace, key=_kernel_key):
    """``(total_us, by_cat, by_key)``: device time in all, and per category
    and per ``key`` of each device event, as ``[us, count]`` (``by_key``
    also carries the category)."""
    total, by_cat, by_key = 0.0, defaultdict(lambda: [0.0, 0]), {}
    for name, us, cat, op in trace.device:
        total += us
        by_cat[cat][0] += us
        by_cat[cat][1] += 1
        row = by_key.setdefault(key(name, cat, op), [0.0, 0, cat])
        row[0] += us
        row[1] += 1
    return total, dict(by_cat), by_key


def print_header(trace):
    m = trace.meta
    where = m.get("nvidia_smi") or m.get("device", "?")
    print(f"program {m.get('program', '?')}: batch {m.get('batch', '?')}, {trace.steps} traced steps, "
          f"seq_len {m.get('seq_len', '?')}, frame {m.get('frame', '?')}, tiny {m.get('tiny', False)}, "
          f"{m.get('compute_dtype', '?')}; {where}; torch {m.get('torch', '?')}")
    if not trace.on_device:
        print("(no device events: a CPU trace; each op's CPU self time stands in for kernels)")
    else:
        print(f"{trace.linked} of {len(trace.device)} device events linked to the op that launched them")


def print_stats(trace, tool, top):
    key = _op_key if tool == "op_stats" else _kernel_key
    total, by_cat, by_key = kernel_stats(trace, key)
    print(f"total kernel self time: {total / 1e3:.3f} ms (across {trace.steps} traced steps)")
    print(f"{'category':<16} {'ms':>10} {'%':>6} {'count':>7}")
    cats = sorted(by_cat.items(), key=lambda kv: -kv[1][0])
    for cat, (us, n) in cats:
        print(f"{cat:<16} {us / 1e3:10.3f} {100 * us / max(total, 1e-12):6.1f} {n:7d}")
    what = "ops" if tool == "op_stats" else "kernels"
    print(f"\ntop {top} {what} by self time:")
    rows = sorted(by_key.items(), key=lambda kv: -kv[1][0])
    for name, (us, n, cat) in rows[:top]:
        print(f"{us / 1e3:10.3f} ms  x{n:<5} {cat:<14} {name[:90]}")
    return {"total_ms": total / 1e3,
            "categories": {cat: {"ms": us / 1e3, "share": us / max(total, 1e-12), "count": n} for cat, (us, n) in cats},
            "top": [[name[:120], us / 1e3, n, cat] for name, (us, n, cat) in rows[:top]]}


def _tensor_bytes(dims, dtype):
    return int(np.prod(dims)) * DTYPE_BYTES.get(dtype, 4) if isinstance(dims, list) else 0


def _ints(text, n):
    vals = [int(v) for v in re.findall(r"-?\d+", text or "")]
    return (vals * n)[:n] if len(vals) == 1 else vals


def output_shapes(op):
    """The shapes of ``op``'s outputs where its inputs determine them (the
    convolutions, their backward, the matrix products), else ``None``."""
    dims = op.args.get("Input Dims") or []
    concrete = op.args.get("Concrete Inputs") or []
    name = op.name
    if name in CONV_OPS and len(dims) >= 2 and len(dims[0]) == 4 and len(dims[1]) == 4:
        (n, _, h, w), (o, _, kh, kw) = dims[0], dims[1]
        stride, pad, dil = (_ints(concrete[i] if len(concrete) > i else "", 2) or [d, d]
                            for i, d in ((3, 1), (4, 0), (5, 1)))
        oh = (h + 2 * pad[0] - dil[0] * (kh - 1) - 1) // stride[0] + 1
        ow = (w + 2 * pad[1] - dil[1] * (kw - 1) - 1) // stride[1] + 1
        return [[n, o, oh, ow]]
    if name == "aten::convolution_backward" and len(dims) >= 3:
        return [dims[1], dims[2]]  # grad input, grad weight
    tensors = [d for d in dims if d]  # scalars record no dims
    if name in ("aten::mm", "aten::addmm") and len(tensors) >= 2:
        a, b = tensors[-2], tensors[-1]  # addmm: (bias, a, b)
        return [[a[0], b[-1]]] if len(a) == 2 and len(b) == 2 else None
    if name in ("aten::bmm", "aten::baddbmm") and len(tensors) >= 2:
        a, b = tensors[-2], tensors[-1]
        return [[a[0], a[1], b[2]]] if len(a) == 3 and len(b) == 3 else None
    return None


def least_bytes(op, children):
    """Bytes ``op`` must move at least: each recorded input once and each
    output it implies once, taken from the shallowest op of its subtree that
    implies its outputs (``output_shapes``), else ``op``'s inputs alone.
    Returns ``(bytes, dtype of the first input)``."""
    queue = [op]
    while queue:
        cur = queue.pop(0)
        outs = output_shapes(cur)
        if outs is not None:
            break
        queue.extend(children.get(id(cur), ()))
    else:
        cur, outs = op, []
    dims = cur.args.get("Input Dims") or []
    types = cur.args.get("Input type") or []
    tensors = [(d, t) for d, t in zip(dims, types) if isinstance(d, list) and d and t in DTYPE_BYTES]
    dtype = tensors[0][1] if tensors else None
    total = sum(_tensor_bytes(d, t) for d, t in tensors) + sum(_tensor_bytes(d, dtype) for d in outs)
    return total, dtype


def roofline(trace, pattern):
    """Rows of ``--roofline``, one per op name: the op instances whose name
    or whose kernels' dominant category matches ``pattern``, each raised to
    the outermost op around it that launched no other kernel (``conv2d``
    around ``convolution``), and counted in an enclosing matching op where
    there is one."""
    rx = re.compile(pattern)
    children = defaultdict(list)
    for op in trace.ops:
        if op.parent is not None:
            children[id(op.parent)].append(op)

    def matches(op):
        if rx.search(op.name):
            return True
        return bool(op.by_cat) and bool(rx.search(max(op.by_cat.items(), key=lambda kv: kv[1])[0]))

    def flops(op):
        return float(op.args.get("flops") or 0) + sum(flops(c) for c in children.get(id(op), ()))

    picked = {}
    for op in trace.ops:
        if op.kernel_us <= 0 or not matches(op):
            continue
        while op.parent is not None and op.parent.kernel_us <= op.kernel_us + 1e-9:
            op = op.parent
        up = op.parent
        while up is not None and not matches(up):
            up = up.parent
        if up is None:  # else counted in the enclosing matching op
            picked[id(op)] = op
    rows = {}
    for op in picked.values():
        nbytes, dtype = least_bytes(op, children)
        row = rows.setdefault(op.name, {"name": op.name, "us": 0.0, "occ": 0, "flops": 0.0, "bytes": 0,
                                        "dtype": dtype})
        row["us"] += op.kernel_us
        row["occ"] += 1
        row["flops"] += flops(op)
        row["bytes"] += nbytes
    out = []
    for row in rows.values():
        s = row["us"] / 1e6
        peak_ops = PEAK_BF16_OPS if row["dtype"] in ("c10::BFloat16", "c10::Half") else PEAK_FP32_OPS
        tflops = row["flops"] / s / 1e12 if row["flops"] else 0.0
        gbytes = row["bytes"] / s / 1e9
        pct_ops, pct_bytes = 100 * tflops * 1e12 / peak_ops, 100 * gbytes * 1e9 / PEAK_BYTES
        out.append({"name": row["name"], "ms_step": row["us"] / 1e3 / trace.steps, "occ": row["occ"],
                    "tflop": row["flops"] / 1e12, "tflops_s": tflops, "gbytes_s": gbytes, "dtype": row["dtype"],
                    "pct_ops": pct_ops, "pct_bytes": pct_bytes,
                    "bound": "operations" if pct_ops >= pct_bytes else "bytes"})
    out.sort(key=lambda r: -r["ms_step"])
    return out


def print_roofline(trace, pattern):
    rows = roofline(trace, pattern)
    total = sum(r["ms_step"] for r in rows)
    print(f"\nroofline /{pattern}/: {len(rows)} matching ops, {total:.3f} ms/step "
          f"(peaks: {PEAK_BF16_OPS / 1e12:.0f} TFLOP/s bf16, {PEAK_FP32_OPS / 1e12:.0f} fp32, "
          f"{PEAK_BYTES / 1e9:.0f} GB/s; NVIDIA H100 80GB HBM3 data sheet, 700 W)")
    print(f"{'ms/step':>9} {'x':>5} {'TFLOP/s':>8} {'%ops':>6} {'GB/s':>8} {'%bytes':>7}  {'bound':<10} name")
    for r in rows:
        rate = f"{r['tflops_s']:8.2f} {r['pct_ops']:6.1f}" if r["tflop"] else f"{'-':>8} {'-':>6}"
        print(f"{r['ms_step']:9.3f} {r['occ']:>5} {rate} {r['gbytes_s']:8.1f} {r['pct_bytes']:7.1f}  "
              f"{r['bound'] if r['tflop'] else 'bytes':<10} {r['name'][:70]}")
    if rows and not any(r["tflop"] for r in rows):
        cols = sorted({k for op in trace.ops for k in op.args})
        print("\n(the profiler counted no flops for these ops; the columns it recorded:)", cols)
    return rows


def report(logdir, tool="kernel_stats", top=25, pattern=""):
    """Print the ``tool`` table (and the roofline for ``pattern``) of
    ``logdir/trace.json``; returns what was printed, as a dict."""
    if tool == "list":
        print(list(TOOLS))
        return {"tools": list(TOOLS)}
    path = osp.join(logdir, "trace.json")
    if not osp.isfile(path):
        raise SystemExit(f"no trace.json under {logdir}")
    trace = Trace(path)
    print_header(trace)
    out = {"meta": trace.meta, "on_device": trace.on_device, "linked": [trace.linked, len(trace.device)],
           **print_stats(trace, tool, top)}
    if pattern:
        out["roofline"] = print_roofline(trace, pattern)
    return out


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seq_len", type=int, default=8)
    ap.add_argument("--tool", default="kernel_stats", choices=TOOLS)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--logdir", default="")
    ap.add_argument("--report-only", action="store_true", help="skip capture; read an existing --logdir")
    ap.add_argument("--roofline", default="",
                    help="per-op roofline for ops whose name or kernel category matches this regex "
                         "(e.g. 'convolution')")
    ap.add_argument("--program", default="train", choices=["train", "describe"], help="which program to trace")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu for the tests)")
    ap.add_argument("--tiny", action="store_true", help="the CLIs' tiny trunk (CPU tests)")
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--width", type=int, default=128)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.tool == "list":
        return report("", "list")
    logdir = args.logdir or tempfile.mkdtemp(prefix=f"torchprof_b{args.batch}_")
    if not args.report_only:
        fn = capture_describe if args.program == "describe" else capture
        fn(args.batch, args.steps, args.seq_len, logdir, device=args.device, tiny=args.tiny,
           frame=(args.height, args.width))
        print(f"trace captured in {logdir}", file=sys.stderr)
    return report(logdir, args.tool, args.top, args.roofline)


if __name__ == "__main__":
    main()
