"""Write a full-size random-init train-state checkpoint (counterpart of
``tools/make_random_checkpoint.py``).

Serving and evaluation measurements (``export-model``, ``serve``) need a
``checkpoint_best.npz`` but not trained weights: the descriptor's
arithmetic and shapes do not depend on them. This builds one on the host
in a few seconds, through ``cli.train``'s ``build_models`` and
``init_train_state``, and writes it in grl_tpu's npz format
(``utils/serialization.py``), so either package's ``load_train_state``
reads it.

    python3 -m grl_tpu_torch.tools.make_random_checkpoint -o ckpt/checkpoint_best.npz \\
        [--num-classes 625] [--tiny] [--seed 0]
"""

from __future__ import annotations

import argparse
import os
import os.path as osp


def write_random_checkpoint(out, num_classes=625, tiny=False, seed=0):
    """Random-init train state of ``cli.train``'s models (``tiny``: one
    bottleneck per stage at width 4, as ``--tiny``) with ``num_classes``
    OIM rows, written to ``out``; returns ``out``."""
    from ..cli.train import build_models
    from ..engine import init_train_state
    from ..utils import save_train_state

    args = argparse.Namespace(arch2="siamese", seed=seed)
    cnn, siamese, siamese_uncorr = build_models(args, tiny=tiny)
    state = init_train_state(cnn, siamese, siamese_uncorr, num_classes, num_feat=cnn.num_feat, device="cpu")
    os.makedirs(osp.dirname(osp.abspath(out)), exist_ok=True)
    save_train_state(state, {"epoch": 0, "best_top1": 0.0}, out)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-o", "--out", required=True)
    ap.add_argument("--num-classes", type=int, default=625)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    write_random_checkpoint(args.out, args.num_classes, args.tiny, args.seed)
    print(f"wrote random-init train state ({args.num_classes} classes, "
          f"{'tiny' if args.tiny else 'full'}) to {args.out}")


if __name__ == "__main__":
    main()
