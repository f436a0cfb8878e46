"""Sweep the backend's options on the dense-eval descriptor program
(counterpart of ``tools/sweep_compiler_options.py``).

grl_tpu's sweep compiled the bf16 descriptor under each XLA compiler
option. Eager PyTorch compiles nothing; what stands in for those options
here is the backend's options that leave the math as it is (TF32 is never
one of them: the CLIs' policy keeps it off):

- ``default``: the port as it runs (``make_descriptor_fn``, NCHW weights,
  cuDNN's heuristics);
- ``cudnn_benchmark``: ``torch.backends.cudnn.benchmark`` on (cuDNN times
  its algorithms for each new shape and keeps the fastest), in a process
  of its own so that its search starts from an empty plan cache;
- ``channels_last``: the modules' 4-d weights in NHWC;
- ``channels_last_benchmark``: both, in a process of its own;
- ``cuda_graph``: the descriptor exported as ``export-model`` exports it
  (before the sweep), captured once as one CUDA graph and replayed, as
  ``cli/extract.py::_GraphCall`` does for the artifact (the capture lands
  in the first call's seconds);
- ``default2``: ``default`` again, for the noise.

The program is grl_tpu's: bf16 ``resnet50_grl`` (seed 0) and the
``siamese`` head 2048 -> 512 (seed 1), built by ``bench.build_models``, at
micro-batch 96 x 8 x 256x128 uint8 clips. Each variant prints the seconds
of its first call (where autotuning and the capture land; grl_tpu prints
compile seconds there), then three rates of ``timed(10)`` after
``timed(2)``; a window chains the outputs into one scalar and ends on its
host read, as ``bench.py`` does. Each variant's descriptor is held within
1e-2 (bf16) of ``default``'s, the reading printed. No default of the port
changes: the flags and the modules are put back after each variant.

    python3 -m grl_tpu_torch.tools.sweep_compiler_options [--device cuda]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from .. import resolve_device, set_precision
from ..bench import build_models
from ..cli.extract import _DescriptorProgram
from ..engine import make_descriptor_fn
from ..utils.profiling import card_line

VARIANTS = ("default", "cudnn_benchmark", "channels_last", "channels_last_benchmark", "cuda_graph", "default2")
# cuDNN keeps one plan cache per process and its key leaves the benchmark
# flag out: a variant that autotunes after another at the same shapes would
# reuse the other's plans and search nothing, so these run each in a
# process of their own
FRESH = ("cudnn_benchmark", "channels_last_benchmark")
TOL = 1e-2  # bf16 descriptors of the same weights and clips under another algorithm or layout
BATCH, SEQ_LEN, FRAME = 96, 8, (256, 128)  # grl_tpu's micro-batch of 8 x 256x128 clips
ITERS, WINDOWS, WARM = 10, 3, 2  # calls per timed window, timed windows, calls of the warm window
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def in_child(module, *args, env=None):
    """``grl_tpu_torch.tools.<module>._child(*args)`` in a fresh Python
    process (``args`` pass as JSON); the JSON object on the last line of
    its output."""
    env = {**os.environ, **(env or {}),
           "PYTHONPATH": os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p)}
    code = f"import json, sys; from grl_tpu_torch.tools.{module} import _child; _child(*json.loads(sys.argv[1]))"
    proc = subprocess.run([sys.executable, "-c", code, json.dumps(args)], env=env, capture_output=True, text=True,
                          timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(f"the child for {module}{args} exited {proc.returncode}: {proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def export_program(cnn, sia, clips):
    """The descriptor program as ``export-model`` exports it
    (``torch.export``): the normalization's constants are lifted into the
    program, where eager ``normalize`` copies them to the card on every
    call, which a capture refuses. Called outside inference mode, before
    any variant rewrites the modules' parameters as inference tensors,
    which the export cannot trace."""
    return torch.export.export(_DescriptorProgram(cnn, sia).eval(), (clips,)).module()


def graph_describe(program, clips):
    """``program`` captured once as a CUDA graph over the static ``clips``
    after warm runs on a side stream, as ``_GraphCall`` captures the
    artifact; the returned call replays it and gives the graph's output
    tensor."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            program(clips)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = program(clips)

    def replay(_clips):
        graph.replay()
        return out

    return replay


@contextlib.contextmanager
def variant(name, modules):
    """The backend as ``name`` asks, put back on exit."""
    benchmark = torch.backends.cudnn.benchmark
    layout = torch.channels_last if name.startswith("channels_last") else torch.contiguous_format
    torch.backends.cudnn.benchmark = name.endswith("benchmark")
    for m in modules:
        m.to(memory_format=layout)
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = benchmark
        for m in modules:
            m.to(memory_format=torch.contiguous_format)


def prepare(device, batch, seq_len, frame, graph):
    """bench.py's modules on ``device``, their descriptor, seeded uint8
    clips and, where ``graph``, the exported program to capture."""
    cnn, sia = build_models(device)
    clips = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (batch, seq_len, *frame, 3), np.uint8))
    clips = clips.to(device)
    return cnn, sia, make_descriptor_fn(cnn, sia), export_program(cnn, sia, clips) if graph else None, clips


def run_variant(name, cnn, sia, describe, program, clips, iters, windows, warm):
    """One variant in this process: its row (the first call's seconds and
    ``windows`` rates) and its first descriptor."""
    device, batch = clips.device, clips.shape[0]
    with torch.inference_mode(), variant(name, (cnn, sia)):
        t0 = time.perf_counter()
        fn = graph_describe(program, clips) if name == "cuda_graph" else describe
        first = fn(clips).clone()  # the graph's output is rewritten by every replay
        float(first.sum())  # the first call ends on a host read
        first_s = time.perf_counter() - t0

        def timed(n):
            t0 = time.perf_counter()
            acc = torch.zeros((), dtype=torch.float32, device=device)
            for _ in range(n):
                acc = acc + fn(clips).sum()
            float(acc)
            return time.perf_counter() - t0

        timed(warm)
        rates = [batch * iters / timed(iters) for _ in range(windows)]
    return {"first_call_s": first_s, "clips_per_s": rates}, first


def _child(device, name, sizes, path):
    """``sweep``'s fresh variants: ``name`` alone in this process, under
    the CLIs' policy; its row on the last line, its first descriptor saved
    at ``path``."""
    set_precision()
    device = resolve_device(device)
    mods = prepare(device, sizes["batch"], sizes["seq_len"], sizes["frame"], name == "cuda_graph")
    row, first = run_variant(name, *mods, sizes["iters"], sizes["windows"], sizes["warm"])
    np.save(path, first.float().cpu().numpy())
    print(json.dumps(row))


def sweep(device="cuda", batch=BATCH, seq_len=SEQ_LEN, frame=FRAME, iters=ITERS, windows=WINDOWS, warm=WARM,
          variants=VARIANTS, report=print):
    """``{variant: {"first_call_s", "clips_per_s": [...], "max_abs_diff"}}``;
    ``report`` gets one line per variant. The ``FRESH`` variants run each
    in a child process (``in_child``), the rest in this one. On the CPU
    ``cuda_graph`` is skipped (``{"skipped": reason}``)."""
    device = resolve_device(device)
    sizes = {"batch": batch, "seq_len": seq_len, "frame": list(frame), "iters": iters, "windows": windows,
             "warm": warm}
    mods, out, ref = None, {}, None
    for name in variants:
        if name == "cuda_graph" and device.type != "cuda":
            out[name] = {"skipped": "CUDA graphs need a card"}
            report(f"{name}: skipped (CUDA graphs need a card)")
            continue
        if name in FRESH:
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "first.npy")
                row = in_child("sweep_compiler_options", str(device), name, sizes, path)
                first = torch.from_numpy(np.load(path)).to(device)
        else:
            if mods is None:
                mods = prepare(device, batch, seq_len, frame, "cuda_graph" in variants and device.type == "cuda")
            row, first = run_variant(name, *mods, iters, windows, warm)
        if ref is None:
            ref = first
        row["max_abs_diff"] = diff = float((first - ref).abs().max())
        out[name] = row
        rates = row["clips_per_s"]
        report(f"{name}: {', '.join(f'{r:.1f}' for r in rates)} clips/s (first call {row['first_call_s']:.2f}s"
               f"{', own process' if name in FRESH else ''}, max abs diff from {variants[0]} {diff:.2e})")
        if not diff <= TOL:
            raise RuntimeError(f"{name}'s descriptor is {diff} from {variants[0]}'s (tolerance {TOL})")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", type=str, default="cuda", help="torch device (default cuda; cpu runs on the host)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    set_precision()
    print(f"card: {card_line(device)}", flush=True)
    res = sweep(device, BATCH, SEQ_LEN, FRAME, ITERS, WINDOWS, WARM, report=lambda line: print(line, flush=True))
    print(json.dumps({"batch": BATCH, "seq_len": SEQ_LEN, "frame": list(FRAME), "dtype": "bfloat16",
                      "variants": res}))
    return res


if __name__ == "__main__":
    main()
