"""Standalone evaluation entry point (counterpart of ``grl_tpu/cli/evaluate.py``).

``python -m grl_tpu_torch.cli.evaluate -d mars --data-dir ... --logs-dir ...``

Loads a checkpoint (``--checkpoint``, default ``<logs-dir>/checkpoint_best.npz``;
one this package or grl_tpu wrote), dense-samples every tracklet, reports
CMC/mAP, optionally after k-reciprocal re-ranking (``--rerank 1``, on the
min-plus kernel on the card), and with ``--save-distmat`` writes the final
distance matrix and ids in grl_tpu's npz keys. It runs in fp32 with TF32
off, or with ``--bf16`` in bfloat16 compute (the descriptor stays fp32,
so re-ranking and the min-plus kernel take fp32). ``--use-flow``
evaluates a flow-trained checkpoint on 6-channel RGB|flow clips (iLIDS-VID
and PRID-2011). ``--visual 1`` writes the ranked strips under
``<logs-dir>/visual``. ``--visual-from NPZ`` reads a ``--save-distmat``
file, runs the host protocol on it and renders its strips, with no model,
no checkpoint and no device: it is host-only by design, as grl_tpu's.
"""

from __future__ import annotations

import argparse
import os.path as osp

import numpy as np

from .. import resolve_device, set_precision
from ..config import PRESETS, ExperimentConfig
from ..data import get_data
from ..engine import Evaluator, eval_items, init_train_state, metrics, print_protocol
from ..engine.visualize import visualize_ranked_results
from ..utils import load_train_state
from .train import DATASETS, _synthetic_kwargs, build_models, open_log, validate_args


def visual_from(args, query_loader, gallery_loader):
    """``--visual-from``: the protocol and the ranked strips of a saved
    distance matrix, on the host; returns rank-1."""
    blob = np.load(args.visual_from)
    distmat = blob["distmat"]
    q_items, g_items = eval_items(query_loader, gallery_loader)
    if distmat.shape != (len(q_items), len(g_items)):
        raise SystemExit(f"saved distmat is {distmat.shape} but the catalogs are "
                         f"({len(q_items)}, {len(g_items)}): was it saved from the same dataset/split?")
    cmc_curve, mAP = metrics.evaluate(distmat, blob["q_pids"], blob["g_pids"], blob["q_camids"], blob["g_camids"])
    print_protocol(cmc_curve, mAP)
    vis_dir = osp.join(args.logs_dir, "visual")
    visualize_ranked_results(distmat, q_items, g_items, vis_dir)
    print(f"saved ranked visualizations to {vis_dir}")
    print("rank-1 accuracy is", float(cmc_curve[0]))
    return float(cmc_curve[0])


def main(args):
    set_precision()
    validate_args(args)
    open_log(args.logs_dir, "test")
    print(f"==========\nArgs:{args}\n==========")
    _, num_classes, _, query_loader, gallery_loader = get_data(
        args.dataset, args.data_dir, args.batch_size, args.seq_len, args.seq_srd, args.workers,
        only_eval=True, split_id=args.split,
        dataset_kwargs=_synthetic_kwargs(args), use_flow=bool(args.use_flow),
    )
    if args.visual_from:
        return visual_from(args, query_loader, gallery_loader)

    device = resolve_device(args.device)
    print(f"device: {device}")
    cnn, siamese, siamese_uncorr = build_models(args, tiny=args.tiny)
    state = init_train_state(cnn, siamese, siamese_uncorr, num_classes, num_feat=cnn.num_feat,
                             device=device)
    ckpt = args.checkpoint or osp.join(args.logs_dir, "checkpoint_best.npz")
    load_train_state(state, ckpt)
    print(f"loaded {ckpt}")

    cfg = ExperimentConfig.from_args(args)
    evaluator = Evaluator(cnn, siamese, micro_batch=cfg.eval.micro_batch, rerank=bool(args.rerank),
                          rerank_k1=cfg.eval.rerank_k1, rerank_k2=cfg.eval.rerank_k2,
                          rerank_lambda=cfg.eval.rerank_lambda, save_distmat=args.save_distmat or None,
                          visual_dir=osp.join(args.logs_dir, "visual") if args.visual else None, device=device)
    top1 = float(evaluator.evaluate(query_loader, gallery_loader).cmc[0])
    print("rank-1 accuracy is", top1)
    return top1


def build_parser():
    # defaults from the typed test_all preset (config.py)
    cfg = PRESETS["test_all"]()
    parser = argparse.ArgumentParser(description="GRL evaluation (PyTorch/CUDA)")
    parser.add_argument("-d", "--dataset", type=str, default=cfg.data.dataset, choices=DATASETS)
    parser.add_argument("-b", "--batch-size", type=int, default=cfg.data.batch_size)
    parser.add_argument("-j", "--workers", type=int, default=cfg.data.workers)
    parser.add_argument("--seq_len", type=int, default=cfg.data.seq_len)
    parser.add_argument("--seq_srd", type=int, default=cfg.data.seq_srd)
    parser.add_argument("--split", type=int, default=cfg.data.split)
    parser.add_argument("--arch1", type=str, default=cfg.model.arch1)
    parser.add_argument("--arch2", type=str, default=cfg.model.arch2)
    parser.add_argument("--features", type=int, default=cfg.model.features)
    parser.add_argument("--dropout", type=float, default=cfg.model.dropout)
    parser.add_argument("--seed", type=int, default=cfg.seed)
    parser.add_argument("--rerank", type=int, default=0)
    parser.add_argument("--visual", type=int, default=0,
                        help="write the ranked strips under <logs-dir>/visual")
    parser.add_argument("--save-distmat", type=str, default="", dest="save_distmat", metavar="NPZ",
                        help="write the final (post-rerank) distance matrix + pids/camids")
    parser.add_argument("--visual-from", type=str, default="", dest="visual_from", metavar="NPZ",
                        help="re-render ranked strips + re-run the protocol from a --save-distmat npz "
                             "on the host (no checkpoint, no device)")
    parser.add_argument("--data-dir", type=str, metavar="PATH", default="")
    parser.add_argument("--logs-dir", type=str, metavar="PATH", default="log/grl")
    parser.add_argument("--checkpoint", type=str, default="")
    parser.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--use-flow", action="store_true",
                        help="sequence datasets only: evaluate a flow-trained checkpoint on 6-channel "
                             "(RGB|flow) clips")
    parser.add_argument("--devices", type=int, default=0,
                        help="cards to evaluate on; above 1 is not ported yet (ROADMAP queue A, item 7)")
    parser.add_argument("--synthetic-ids", type=int, default=0,
                        help="-d synthetic: number of generated train identities, as the "
                             "checkpoint's training run had them (0 = library default)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default cuda; cpu runs on the host)")
    return parser


def cli():
    """Console-script entry point; swallows ``main``'s return value."""
    main(build_parser().parse_args())


if __name__ == "__main__":
    cli()
