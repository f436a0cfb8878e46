"""Training entry point (counterpart of ``grl_tpu/cli/train.py``).

``python -m grl_tpu_torch.cli.train -d mars --data-dir /path/to/MARS ...``

The flags and their defaults are grl_tpu's, plus ``--device`` (default
``cuda``; ``cpu`` runs on the host). Checkpoints are written in grl_tpu's
format (``utils/serialization.py``), so a run can resume from, or be
evaluated by, either package. ``--dataset synthetic`` runs the whole stack
with no data on disk. ``main`` runs in fp32 with TF32 off
(``set_precision``); ``--bf16`` computes every conv and linear in bfloat16
over fp32 parameters, as grl_tpu's does, and writes the same checkpoint
as an fp32 run. ``--use-flow`` (iLIDS-VID and PRID-2011 only) trains the
same GRL model on 6-channel RGB|flow clips through a trunk whose conv1
takes 6 channels; ``--visual 1`` writes the ranked strips of each
evaluation under ``<logs-dir>/visual``.

Data parallelism, as grl_tpu's: ``--devices N`` (default 0: every visible
card) launches one rank per card (``parallel.launch``; the largest count
up to N that divides the batch's pairs, capped at the visible cards), or
N gloo ranks under ``--device cpu``. Every rank draws the global batch and
loads its slice, and the group step equals one card's step on the global
batch. Under ``torchrun`` (``WORLD_SIZE`` > 1) the ranks stand for
grl_tpu's processes: each trains on its identity shard of the catalog with
``--batch-size`` / ranks clips per step. The eval catalogs are striped
over the ranks either way. Only rank 0 writes checkpoints, scalars and the
main log; rank r > 0 logs to ``log_train{N}.p{r}.txt``. A SIGTERM to the
launching process reaches every rank; they stop together (the collective
stop) and rank 0 checkpoints once.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import signal
import sys
import threading

import numpy as np
import torch

from .. import models, parallel, resolve_device, set_precision
from ..config import ExperimentConfig
from ..data import get_data
from ..engine import Evaluator, Trainer, init_train_state, make_train_step, step_decay_lr
from ..utils import (AsyncCheckpointer, Logger, ScalarWriter, load_imagenet_resnet50, load_train_state,
                     mkdir_if_missing)

DATASETS = ["ilidsvidsequence", "prid2011sequence", "mars", "duke", "synthetic"]


def build_models(args, tiny=False):
    """``(cnn, siamese, siamese_uncorr)`` on the CPU with fresh weights from
    ``args.seed``: the full ResNet-50 GRL model, or with ``tiny`` a trunk of
    one bottleneck per stage at width 4 (smoke tests), as grl_tpu builds.
    ``args.bf16`` gives every module ``compute_dtype=torch.bfloat16``;
    ``args.use_flow`` gives the trunk 6 input channels (RGB | flow)."""
    cd = torch.bfloat16 if getattr(args, "bf16", False) else None
    in_ch = 6 if getattr(args, "use_flow", False) else 3
    if tiny:
        trunk = models.ResNetTrunk(layers=(1, 1, 1, 1), width=4, compute_dtype=cd, in_channels=in_ch)
    else:
        trunk = models.resnet50_trunk(last_stride=1, compute_dtype=cd, in_channels=in_ch)
    seed = 3 * args.seed
    cnn = models.create("resnet50_grl", device="cpu", seed=seed, trunk=trunk, compute_dtype=cd)
    siamese = models.create(args.arch2, device="cpu", seed=seed + 1, input_num=cnn.num_feat,
                            output_num=512, class_num=2, compute_dtype=cd)
    siamese_uncorr = models.create("siamese_video", device="cpu", seed=seed + 2, input_num=cnn.num_feat,
                                   compute_dtype=cd)
    return cnn, siamese, siamese_uncorr


def validate_args(args):
    """Reject what grl_tpu rejects, loudly instead of ignoring it."""
    if getattr(args, "loss", "oim") != "oim":
        raise SystemExit(f"--loss {args.loss!r} is not implemented: the GRL training recipe is "
                         "the fixed 5-term OIM/verification/triplet objective; only 'oim' is supported")
    if getattr(args, "dropout", 0.0):
        raise SystemExit("--dropout is accepted for flag parity but has no live consumer; leave it at 0")
    if getattr(args, "sampling_rate", 3) != 3:
        raise SystemExit("--sampling-rate is accepted for flag parity but unused on the live "
                         "path; leave it at 3")
    if args.arch1 != "resnet50_grl":
        raise SystemExit(f"--arch1 {args.arch1!r} has no live train/eval path: the GRL loss "
                         "recipe and the descriptor both need the (x_uncorr, x_corr) GRL outputs")
    if args.features != 2048:
        raise SystemExit("--features is fixed at 2048 on the GRL path (the model's feature width)")
    if getattr(args, "ckpt_freq", 1) < 1:
        raise SystemExit("--ckpt-freq must be >= 1 (eval/best/final epochs always checkpoint regardless)")
    if getattr(args, "use_flow", False) and args.dataset not in ("ilidsvidsequence", "prid2011sequence"):
        raise SystemExit(f"--use-flow: {args.dataset!r} has no optical-flow companions; only the "
                         "sequence datasets ship flow archives")
    method = getattr(args, "sample_method", "rrs")
    if method not in ("rrs", "random"):
        raise SystemExit(f"--sample_method {method!r} unknown: 'rrs' (restricted random sampling) "
                         "or 'random' (consecutive window)")


def _synthetic_kwargs(args):
    """dataset_kwargs for -d synthetic (None for real datasets);
    ``--synthetic-ids`` scales the generated catalog."""
    if args.dataset != "synthetic":
        return None
    kwargs = dict(seed=args.seed)
    n = getattr(args, "synthetic_ids", 0)
    if n:
        kwargs.update(num_train_ids=n, num_test_ids=max(2, n // 2))
    return kwargs


def open_log(logs_dir, tag, rank=0):
    """Tee stdout into the first free ``log_{tag}{N}.txt`` under ``logs_dir``
    (``log_{tag}{N}.p{rank}.txt`` for a rank above 0 of a group, so ranks
    sharing a directory never write one file)."""
    mkdir_if_missing(logs_dir)
    suffix = f".p{rank}" if rank else ""
    run = 0
    while osp.exists(osp.join(logs_dir, f"log_{tag}{run}{suffix}.txt")):
        run += 1
    sys.stdout = Logger(osp.join(logs_dir, f"log_{tag}{run}{suffix}.txt"))


def ranks_to_launch(args, pairs=None):
    """How many ranks ``--devices`` asks for when no group is live:
    ``parallel.auto_mesh``'s rule (every visible card by default, capped by
    ``--devices``, the largest count that divides ``pairs``)."""
    return parallel.auto_mesh(pairs=pairs, limit=args.devices or None, device=args.device)


def say_one_device(args, pairs=None):
    """A ``--devices`` above 1 that runs on one device says so."""
    if args.devices > 1:
        print(f"--devices {args.devices}: running on one {args.device} device "
              f"({parallel.visible_devices(args.device)} visible, {pairs} pairs per batch)")


def check_multihost(args, mesh, pairs=None):
    """grl_tpu's refusals for a multi-process launch: every rank's card must
    take part in the collectives, and each rank must hold whole pairs."""
    if not mesh.multihost:
        return
    if pairs is not None and args.batch_size % (2 * mesh.size):
        raise SystemExit(f"--batch-size {args.batch_size} must be a multiple of 2 * process_count "
                         f"({2 * mesh.size}) so every host gets whole pairs")
    if args.devices and args.devices < mesh.size:
        raise SystemExit(f"multi-host: --devices {args.devices} caps the mesh below the global device count "
                         f"({mesh.size}); every chip must participate in the collectives; drop --devices")


def eval_meta(dataset):
    """``Evaluator.evaluate``'s ``multihost`` dict for the whole catalogs."""
    return {"query": parallel.eval_catalog_meta(dataset.query),
            "gallery": parallel.eval_catalog_meta(dataset.gallery)}


class _NoCheckpoints:
    """The checkpointer of a rank above 0: the state is the same on every
    rank, and rank 0 writes it."""

    def save(self, *a, **k):
        pass

    def wait(self):
        pass


def main(args):
    set_precision()
    validate_args(args)
    pairs = None if args.evaluate else args.batch_size // 2
    mesh = parallel.maybe_initialize_distributed(args.device)
    if mesh is None and (n := ranks_to_launch(args, pairs)) > 1:
        return parallel.launch(main, args, n, args.device)[0]
    rank = 0 if mesh is None else mesh.rank
    device = resolve_device(args.device) if mesh is None else mesh.device
    np.random.seed(args.seed)
    open_log(args.logs_dir, "test" if args.evaluate else "train", rank)
    print(f"==========\nArgs:{args}\n==========")
    print(f"device: {device}")
    local_batch, batch_slice = args.batch_size, None
    if mesh is None:
        say_one_device(args, pairs)
    else:
        check_multihost(args, mesh, pairs)
        print(f"data parallel: {mesh}")
        if mesh.multihost:
            # --batch-size is the global batch; each rank loads its share
            # of it from its identity shard
            local_batch = args.batch_size // mesh.size
            print(f"multi-host: {mesh.size} processes, {local_batch} clips/host/step")
        else:
            b = args.batch_size // mesh.size
            batch_slice = slice(mesh.rank * b, (mesh.rank + 1) * b)

    cfg = ExperimentConfig.from_args(args)
    dataset, num_classes, train_loader, query_loader, gallery_loader = get_data(
        args.dataset, args.data_dir, local_batch, args.seq_len, args.seq_srd, args.workers,
        only_eval=bool(args.evaluate), split_id=args.split, eval_batch=cfg.data.eval_batch_size,
        dataset_kwargs=_synthetic_kwargs(args),
        train_sample="random" if args.sample_method == "random" else "rrs_train",
        use_flow=bool(args.use_flow), process_shard=bool(mesh and mesh.multihost),
        eval_stripe=mesh is not None, batch_slice=batch_slice,
    )
    multihost = None if mesh is None else eval_meta(dataset)

    cnn, siamese, siamese_uncorr = build_models(args, tiny=args.tiny)
    state = init_train_state(cnn, siamese, siamese_uncorr, num_classes, num_feat=cnn.num_feat,
                             momentum=args.momentum, weight_decay=args.weight_decay, device=device)
    if args.pretrained_trunk:
        load_imagenet_resnet50(cnn.backbone.base, dict(np.load(args.pretrained_trunk)))
        print(f"loaded ImageNet trunk from {args.pretrained_trunk}")

    ckpt_path = osp.join(args.logs_dir, "checkpoint.npz")
    best_path = "checkpoint_best.npz"
    if args.resume:
        extras = load_train_state(state, args.resume)
        start_epoch = int(extras["epoch"])
        best_top1 = float(extras["best_top1"])
        print(f"resumed from {args.resume} at epoch {start_epoch} (best {best_top1:.1%})")
    else:
        start_epoch, best_top1 = args.start_epoch, 0.0
    if mesh is not None:
        parallel.sharded_train_state(state, mesh)

    evaluator = Evaluator(cnn, siamese, micro_batch=cfg.eval.micro_batch, rerank=bool(args.rerank),
                          rerank_k1=cfg.eval.rerank_k1, rerank_k2=cfg.eval.rerank_k2,
                          rerank_lambda=cfg.eval.rerank_lambda,
                          visual_dir=osp.join(args.logs_dir, "visual") if args.visual else None, device=device,
                          mesh=mesh)
    if args.evaluate:
        load_train_state(state, osp.join(args.logs_dir, best_path))
        top1 = float(evaluator.evaluate(query_loader, gallery_loader, multihost=multihost).cmc[0])
        print("best rank-1 accuracy is", top1)
        return top1

    # stale scalar files are wiped only on fresh runs: a resumed run keeps
    # its earlier curves. The scalars are the global batch's, the same on
    # every rank: rank 0 writes them
    writer = None
    if rank == 0:
        writer = ScalarWriter(osp.join(args.logs_dir, "train_log"), tensorboard=bool(args.tensorboard),
                              wipe=not args.resume)
    step_fn = make_train_step(oim_scalar=args.oim_scalar, oim_momentum=args.oim_momentum, device=device,
                              mesh=mesh)
    # graceful preemption: the handler asks the trainer to stop at the next
    # step boundary, the loop below checkpoints and returns; --resume
    # replays the interrupted epoch
    stop = threading.Event()

    def _request_stop(signum, _frame):
        print(f"\nsignal {signum}: stopping at the next step boundary to checkpoint")
        stop.set()

    prev_handlers = []
    try:
        for sig in (signal.SIGTERM, signal.SIGINT):
            prev_handlers.append((sig, signal.signal(sig, _request_stop)))
    except ValueError:
        pass  # not the main thread (embedded use): no preemption handling

    trainer = Trainer(step_fn, writer, seed=args.seed, stop_event=stop, device=device, mesh=mesh)
    # the write of a checkpoint overlaps the next epoch's training; the
    # state is the same on every rank, and rank 0 writes it
    checkpointer = AsyncCheckpointer() if rank == 0 else _NoCheckpoints()
    try:
        for epoch in range(start_epoch, args.epochs):
            lr = step_decay_lr(args.lr, epoch, args.lr_step)
            print(lr)
            state, stats = trainer.train(epoch, state, train_loader, lr)
            if stop.is_set():
                checkpointer.save(state, {"epoch": epoch, "best_top1": best_top1}, ckpt_path)
                checkpointer.wait()
                if rank == 0:
                    print(f"preempted during epoch {epoch}: state saved to {ckpt_path}; "
                          f"continue with --resume {ckpt_path}")
                else:
                    print(f"preempted during epoch {epoch}: rank 0 saves the state")
                break
            print(f"epoch {epoch}: loss {stats['loss']:.3f} "
                  f"batch {stats['batch_time']:.3f}s data {stats['data_time']:.3f}s")

            do_eval = (epoch + 1) % 5 == 0 or (epoch + 1) == args.epochs or (
                (epoch + 1) > 30 and (epoch + 1) % 3 == 0)
            is_best = False
            if do_eval:
                top1 = float(evaluator.evaluate(query_loader, gallery_loader, multihost=multihost).cmc[0])
                is_best = top1 > best_top1
                best_top1 = max(top1, best_top1)
            # every --ckpt-freq epochs; eval, best and final epochs always
            if (epoch + 1) % args.ckpt_freq == 0 or is_best or do_eval or (epoch + 1) == args.epochs:
                checkpointer.save(state, {"epoch": epoch + 1, "best_top1": best_top1}, ckpt_path,
                                  is_best=is_best, best_name=best_path)
        checkpointer.wait()
    finally:
        for sig, handler in prev_handlers:
            signal.signal(sig, handler)
    if writer is not None:
        writer.close()
    return best_top1


def build_parser():
    # the defaults come from the typed config (config.py)
    cfg = ExperimentConfig()
    parser = argparse.ArgumentParser(description="GRL training (PyTorch/CUDA)")
    parser.add_argument("-d", "--dataset", type=str, default=cfg.data.dataset, choices=DATASETS)
    parser.add_argument("-b", "--batch-size", type=int, default=cfg.data.batch_size)
    parser.add_argument("-j", "--workers", type=int, default=cfg.data.workers)
    parser.add_argument("--seq_len", type=int, default=cfg.data.seq_len)
    parser.add_argument("--seq_srd", type=int, default=cfg.data.seq_srd)
    parser.add_argument("--split", type=int, default=cfg.data.split)
    parser.add_argument("--arch1", type=str, default=cfg.model.arch1, choices=["resnet50_grl", "resnet50"])
    parser.add_argument("--features", type=int, default=cfg.model.features)
    parser.add_argument("--dropout", type=float, default=cfg.model.dropout)
    parser.add_argument("--arch2", type=str, default=cfg.model.arch2)
    parser.add_argument("--loss", type=str, default="oim", choices=["oim"])
    parser.add_argument("--oim-scalar", type=float, default=cfg.loss.oim_scalar)
    parser.add_argument("--oim-momentum", type=float, default=cfg.loss.oim_momentum)
    parser.add_argument("--sampling-rate", type=int, default=3)
    parser.add_argument("--sample_method", type=str, default="rrs")
    parser.add_argument("--use-flow", action="store_true",
                        help="sequence datasets only: RGB|flow clips into a 6-channel trunk")
    parser.add_argument("--seed", type=int, default=cfg.seed)
    parser.add_argument("--lr", type=float, default=cfg.optim.lr)
    parser.add_argument("--lr_step", type=float, default=cfg.optim.lr_step)
    parser.add_argument("--momentum", type=float, default=cfg.optim.momentum)
    parser.add_argument("--weight-decay", type=float, default=cfg.optim.weight_decay)
    parser.add_argument("--start-epoch", type=int, default=cfg.start_epoch)
    parser.add_argument("--epochs", type=int, default=cfg.epochs)
    parser.add_argument("--evaluate", type=int, default=0)
    parser.add_argument("--visual", type=int, default=0,
                        help="write each evaluation's ranked strips under <logs-dir>/visual")
    parser.add_argument("--rerank", type=int, default=0)
    parser.add_argument("--data-dir", type=str, metavar="PATH", default="")
    parser.add_argument("--logs-dir", type=str, metavar="PATH", default=osp.join(os.getcwd(), "log/grl"))
    parser.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    parser.add_argument("--tiny", action="store_true", help="tiny trunk (smoke tests)")
    parser.add_argument("--resume", type=str, default="", help="checkpoint to resume from (either package's)")
    parser.add_argument("--pretrained-trunk", type=str, default="",
                        help=".npz of torchvision ImageNet resnet50 weights")
    parser.add_argument("--tensorboard", action="store_true",
                        help="also write TensorBoard event files (tensorboardX)")
    parser.add_argument("--devices", type=int, default=0,
                        help="cap the data-parallel card count (0 = every visible card; with --device cpu, "
                             "the number of gloo ranks)")
    parser.add_argument("--synthetic-ids", type=int, default=0,
                        help="-d synthetic: number of generated train identities (0 = library default)")
    parser.add_argument("--ckpt-freq", type=int, default=1,
                        help="checkpoint every N epochs (eval/best/final epochs always save)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default cuda; cpu runs on the host)")
    return parser


def cli():
    """Console-script entry point; swallows ``main``'s return value (the
    best rank-1), which ``sys.exit`` would read as a failure."""
    main(build_parser().parse_args())


if __name__ == "__main__":
    cli()
