"""The port's entry hooks (counterpart of ``__graft_entry__.py``).

``entry(device)`` gives the eval-mode forward of the full-size GRL model
(ResNet-50 + GCE + TRL) and a zero batch of one 8-frame 256x128 clip pair;
``dryrun_multichip(n)`` runs the group programs once over ``n`` ranks of
``parallel.launch`` at tiny shapes: one group training step (model forward
and backward, SGD, the OIM lut updates), then the sharded evaluation tail
(``parallel.sharded_cosine_distance``, ``evaluate_device(mesh=)`` and the
row-sharded ``re_ranking(mesh=)``). Both run on the card unless given
``device="cpu"``. On the card the ranks are NCCL ranks, one per card, while
they fit; more ranks than cards share the cards over gloo (rank i on
``cuda:(i mod cards)``). Every rank re-ranks through ``ops.minplus``: the
min-plus kernel on the card, its plain version on the CPU.

    python3 -m grl_tpu_torch.entry [--device cpu]  # entry's forward once
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import models, ops, parallel, resolve_device, set_precision
from .engine import init_train_state, make_train_step
from .engine.metrics import evaluate_device
from .engine.rerank import re_ranking

CLIP_SHAPE = (2, 8, 256, 128, 3)  # one anchor/positive pair of 8-frame 256x128 clips
NUM_CLASSES = 4
FEAT_DIM = 24  # the dry run's evaluation features
RERANK_K = (4, 2)  # k1, k2


class _Forward(torch.nn.Module):
    """``clips -> (x_uncorr, x_corr)``: the CNN's eval-mode outputs."""

    def __init__(self, cnn):
        super().__init__()
        self.cnn = cnn

    def forward(self, clips):
        x_uncorr, x_corr = self.cnn(clips)
        return x_uncorr, x_corr


def entry(device=None):
    """``(module, example_args)``: the eval-mode forward of the full-size
    ``resnet50_grl`` (weights from seed 0) and a float32 zero batch shaped
    ``CLIP_SHAPE``, both on ``resolve_device(device)``."""
    device = resolve_device(device)
    cnn = models.create("resnet50_grl", device=device, seed=0)
    clips = torch.zeros(CLIP_SHAPE, dtype=torch.float32, device=device)
    return _Forward(cnn).eval(), (clips,)


def dryrun_data(n_devices):
    """The dry run's inputs, drawn from ``RandomState(0)`` in the JAX hook's
    order: clips ``(2p, 2, 32, 16, 3)`` float32 and their ids, ``p`` pairs
    for ``n`` ranks, one per rank, two on one rank (the verification head's
    BatchNorm over pairs needs two in train mode: torch refuses one, where
    grl_tpu's BatchNorm takes it); then ``n`` query and ``2n`` gallery unit
    features with the hook's camera layout (query i: pid i, camera 0; its
    gallery match on camera 1 and a junk entry on camera 0)."""
    rng = np.random.RandomState(0)
    batch = 2 * max(n_devices, 2)
    clips = rng.randn(batch, 2, 32, 16, 3).astype(np.float32)
    pids = np.repeat(np.arange(batch // 2) % NUM_CLASSES, 2).astype(np.int64)
    nq, ng = n_devices, 2 * n_devices
    feats = rng.randn(nq + ng, FEAT_DIM).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    ids = {"q_pids": np.arange(nq), "q_cams": np.zeros(nq, np.int64),
           "g_pids": np.concatenate([np.arange(nq), np.arange(nq)]),
           "g_cams": np.concatenate([np.ones(nq, np.int64), np.zeros(nq, np.int64)])}
    return clips, pids, feats, ids


def _dryrun_rank(n_devices):
    """One rank of ``dryrun_multichip``: returns its results."""
    mesh = parallel.data_mesh(n_devices)
    device = mesh.device
    for fn in ops.KERNELS.values():
        fn.launches = 0
    clips, pids, feats, ids = dryrun_data(n_devices)

    trunk = models.ResNetTrunk(layers=(1, 1, 1, 1), width=4)
    cnn = models.create("resnet50_grl", device=device, seed=0, trunk=trunk)
    siamese = models.create("siamese", device=device, seed=1, input_num=cnn.num_feat, output_num=16)
    uncorr = models.create("siamese_video", device=device, seed=2, input_num=cnn.num_feat)
    state = parallel.sharded_train_state(
        init_train_state(cnn, siamese, uncorr, NUM_CLASSES, num_feat=cnn.num_feat, device=device), mesh)
    step = make_train_step(mesh=mesh)
    state, metrics = step(state, torch.from_numpy(parallel.shard_batch(clips, mesh)).to(device),
                          parallel.shard_batch(pids, mesh), 1e-3)
    loss, prec_frame = float(metrics["loss"]), float(metrics["prec_frame"])
    assert np.isfinite(loss), "multichip step produced non-finite loss"

    # the sharded eval tail: this rank's query rows of the distances, the
    # protocol over the group, re-ranking's stages row-sharded
    nq = ids["q_pids"].shape[0]
    f = torch.from_numpy(feats).to(device)
    distmat = parallel.sharded_cosine_distance(f[:nq], f[nq:], mesh)
    cmc, mAP = evaluate_device(distmat, ids["q_pids"], ids["g_pids"], ids["q_cams"], ids["g_cams"], max_rank=5,
                               mesh=mesh)
    assert np.isfinite(mAP), "multichip protocol produced a non-finite mAP"
    # c = [[q_q, q_g], [q_gᵀ, g_g]] is -f·fᵀ whole; this rank's columns, transposed, are its rows
    start, stop, _ = parallel.row_block(f.shape[0], mesh)
    rr = re_ranking(inputs_box=[-(f[start:stop] @ f.T)], query_num=nq, k1=RERANK_K[0], k2=RERANK_K[1], mesh=mesh)
    rr = rr.cpu().numpy()
    assert np.isfinite(rr).all(), "multichip re-ranking produced non-finite distances"
    return {"rank": mesh.rank, "device": str(device), "backend": torch.distributed.get_backend(), "loss": loss,
            "prec_frame": prec_frame, "mAP": float(mAP), "cmc": np.asarray(cmc).tolist(), "rerank": rr,
            "launches": {name: fn.launches for name, fn in ops.KERNELS.items()}}


def dryrun_multichip(n_devices, device=None, timeout=None):
    """One group training step and the sharded evaluation tail over
    ``n_devices`` new ranks (``parallel.launch``; ``timeout`` seconds for
    them all), each asserting finite results; prints one line in the JAX
    hook's format and returns the ranks' results in rank order."""
    results = parallel.launch(_dryrun_rank, n_devices, n_devices, resolve_device(device), timeout=timeout)
    r0 = results[0]
    print(f"dryrun_multichip({n_devices}): loss={r0['loss']:.4f} prec_frame={r0['prec_frame']:.3f} "
          f"eval(mAP={r0['mAP']:.3f}, rerank {r0['rerank'].shape}) ok")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; cpu runs on the host)")
    args = ap.parse_args(argv)
    set_precision()  # the CLIs' policy
    module, example = entry(args.device)
    with torch.inference_mode():
        out = module(*example)
    print("entry ok:", tuple(tuple(o.shape) for o in out))


if __name__ == "__main__":
    main()
