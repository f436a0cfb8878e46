"""Data-parallel scaling of the training step over 1, 2, 4, ... ranks
(counterpart of ``tools/bench_scaling.py``).

Each width runs the group step (``make_train_step(mesh=)``, global
BatchNorm, the CNN's outputs gathered, gradients summed) on that many
ranks, one per card, with the global batch growing with the group
(``--pairs-per-device`` anchor/positive pairs per rank), so perfect weak
scaling keeps ms/step flat. It prints ms/step, clips/s and the weak-scaling
efficiency (the one-rank step's ms over this width's) for every width up
to the visible cards, then one JSON line. The default is the full-width
model in bf16 on 8 frames of 256x128; ``--tiny`` is grl_tpu's: the tiny
trunk in fp32 on 32x16 frames.

``--device cpu --devices N`` runs the widths up to N as gloo ranks to
validate the path: every rank shares one host's cores, so the CPU times
say nothing of scaling.

    python3 -m grl_tpu_torch.tools.bench_scaling [--tiny] [--pairs-per-device 4] \\
        [--seq_len 8] [--iters 10] [--device cuda] [--devices N]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

NUM_CLASSES = 625  # MARS's train ids (the OIM tables' rows)


def group_steps(opts):
    """On this rank: one warm step, then ``iters`` timed group steps on its
    slice of the global batch; returns the mean seconds per step."""
    from .. import models, parallel, set_precision
    from ..engine import init_train_state, make_train_step

    set_precision()
    mesh = parallel.current_mesh()
    device = mesh.device
    cd = None if opts["tiny"] else torch.bfloat16
    if opts["tiny"]:
        trunk, (h, w) = models.ResNetTrunk(layers=(1, 1, 1, 1), width=4), (32, 16)
    else:
        trunk, (h, w) = models.resnet50_trunk(last_stride=1, compute_dtype=cd), (256, 128)
    cnn = models.create("resnet50_grl", device=device, seed=0, trunk=trunk, compute_dtype=cd)
    sia = models.create("siamese", device=device, seed=1, input_num=cnn.num_feat,
                        output_num=16 if opts["tiny"] else 512, compute_dtype=cd)
    unc = models.create("siamese_video", device=device, seed=2, input_num=cnn.num_feat, compute_dtype=cd)
    state = parallel.sharded_train_state(
        init_train_state(cnn, sia, unc, NUM_CLASSES, num_feat=cnn.num_feat, device=device), mesh)
    step = make_train_step(device=device, mesh=mesh)
    batch = 2 * opts["pairs"] * mesh.size
    rng = np.random.RandomState(0)
    clips = parallel.shard_batch(rng.rand(batch, opts["seq_len"], h, w, 3).astype(np.float32), mesh)
    clips = torch.from_numpy(clips).to(device)
    pids = parallel.shard_batch(np.repeat(np.arange(batch // 2) % NUM_CLASSES, 2), mesh)
    state, m = step(state, clips, pids, 1e-3)  # warm: library set-up, first allocations
    float(m["loss"])
    t0 = time.perf_counter()
    for _ in range(opts["iters"]):
        state, m = step(state, clips, pids, 1e-3)
    loss = float(m["loss"])  # waits for the last step
    return {"seconds": (time.perf_counter() - t0) / opts["iters"], "loss": loss, "batch": batch}


def main(argv=None):
    from .. import parallel

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tiny", action="store_true", help="tiny trunk, fp32, 32x16 frames")
    ap.add_argument("--pairs-per-device", type=int, default=4)
    ap.add_argument("--seq_len", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--devices", type=int, default=0,
                    help="the largest width (0 = every visible card; with --device cpu, gloo ranks)")
    args = ap.parse_args(argv)

    total = parallel.auto_mesh(limit=args.devices or None, device=args.device)
    widths = [d for d in (1, 2, 4, 8, 16, 32) if d <= total]
    opts = {"tiny": args.tiny, "pairs": args.pairs_per_device, "seq_len": args.seq_len, "iters": args.iters}
    rows, base = [], None
    for n in widths:
        out = parallel.launch(group_steps, opts, n, args.device)
        dt = max(r["seconds"] for r in out)  # the group steps together; its slowest rank
        base = dt if base is None else base
        row = {"devices": n, "global_batch": out[0]["batch"], "ms_per_step": dt * 1e3,
               "clips_per_s": out[0]["batch"] / dt, "weak_scaling_eff": base / dt, "loss": out[0]["loss"]}
        rows.append(row)
        print(f"devices={n:3d}  global_batch={row['global_batch']:4d}  {row['ms_per_step']:8.1f} ms/step  "
              f"{row['clips_per_s']:8.0f} clips/s  weak-scaling eff {row['weak_scaling_eff']:.2f}", flush=True)
    print(json.dumps({"scaling": rows, "device": args.device, "tiny": args.tiny}))
    return rows


if __name__ == "__main__":
    main()
