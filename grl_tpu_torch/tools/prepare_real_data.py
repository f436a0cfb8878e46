"""Real-dataset readiness: check the layout, write the split caches, print
the parity run's commands (counterpart of ``tools/prepare_real_data.py``).

Run it first when MARS, DukeMTMC-VideoReID, iLIDS-VID or PRID-2011 land on
disk, so that the first training run spends its time training:

    python3 -m grl_tpu_torch.tools.prepare_real_data mars --data-dir /data/MARS
    python3 -m grl_tpu_torch.tools.prepare_real_data duke --data-dir /data/DukeMTMC-VideoReID
    python3 -m grl_tpu_torch.tools.prepare_real_data ilidsvidsequence --data-dir /data/iLIDS-VID
    python3 -m grl_tpu_torch.tools.prepare_real_data prid2011sequence --data-dir /data/PRID2011

It (1) checks the expected directory and metadata layout, naming every
missing path; (2) for iLIDS-VID and PRID-2011 without ``meta.json`` and
``splits.json``, builds them and the ``images/`` relayout from the raw
download under ``root/raw`` (``data/catalogs/prepare.py``); (3) builds the
catalog through ``data.catalogs.get_sequence``, which parses the metadata,
runs every per-tracklet check and writes the JSON split caches beside the
data; (4) decodes a few frames of each split through ``data/jpeg.py`` and
says which routine decoded them (the native libjpeg routine, or PIL where
it did not build or does not take the file, with the build's error); (5)
prints the dataset's banner and the commands of a reference-parity run
(mars_train.py:146-204 defaults) through the port's entry points. A host
tool: it needs no card.
"""

from __future__ import annotations

import argparse
import os.path as osp
import time

EXPECTED = {
    "mars": [
        "bbox_train",
        "bbox_test",
        "info/train_name.txt",
        "info/test_name.txt",
        "info/tracks_train_info.mat",
        "info/tracks_test_info.mat",
        "info/query_IDX.mat",
    ],
    "duke": ["train", "gallery", "query"],
    "ilidsvidsequence": [],  # built from the raw download by data/catalogs/prepare.py
    "prid2011sequence": [],
}

RECIPES = {
    "mars": (
        "python -m grl_tpu_torch.cli.train -d mars --data-dir {root} "
        "--logs-dir log/mars_grl --pretrained-trunk resnet50_imagenet.npz "
        "-b 16 --seq_len 8 --epochs 60\n"
        "python -m grl_tpu_torch.cli.evaluate -d mars --data-dir {root} "
        "--logs-dir log/mars_grl"
    ),
    "duke": (
        "python -m grl_tpu_torch.cli.train -d duke --data-dir {root} "
        "--logs-dir log/duke_grl --pretrained-trunk resnet50_imagenet.npz "
        "-b 16 --seq_len 8 --epochs 60\n"
        "python -m grl_tpu_torch.cli.evaluate -d duke --data-dir {root} "
        "--logs-dir log/duke_grl"
    ),
    "ilidsvidsequence": (
        "python -m grl_tpu_torch.cli.train -d ilidsvidsequence --data-dir {root} "
        "--split 0 --logs-dir log/ilids_grl -b 16 --seq_len 8 --epochs 60"
    ),
    "prid2011sequence": (
        "python -m grl_tpu_torch.cli.train -d prid2011sequence --data-dir {root} "
        "--split 0 --logs-dir log/prid_grl -b 16 --seq_len 8 --epochs 60"
    ),
}

CLOSING = ("\n(convert ImageNet weights once: python -m grl_tpu_torch.utils.convert_torch "
           "--src resnet50-19c8e357.pth --out resnet50_imagenet.npz; "
           "every visible card is used by default: cap with --devices N)")


def check_layout(name, root):
    missing = [p for p in EXPECTED[name] if not osp.exists(osp.join(root, p))]
    if not osp.isdir(root):
        raise SystemExit(f"--data-dir {root} does not exist")
    if missing:
        raise SystemExit(
            f"{name} layout incomplete under {root}; missing:\n  "
            + "\n  ".join(missing)
            + "\n(expected the official distribution layout; see "
            "grl_tpu_torch/data/catalogs/" + ("mars.py" if name == "mars" else "duke.py")
            + " docstrings)"
        )


def prepare_sequence(name, root):
    """Build a sequence dataset's ``images/``, ``meta.json`` and
    ``splits.json`` from ``root/raw`` unless they are there; returns
    whether it built them."""
    if osp.isfile(osp.join(root, "meta.json")) and osp.isfile(osp.join(root, "splits.json")):
        return False
    from ..data.catalogs import prepare_ilidsvid, prepare_prid2011

    t0 = time.time()
    ids, splits = (prepare_ilidsvid if name == "ilidsvidsequence" else prepare_prid2011)(root)
    print(f"prepared {name} from {osp.join(root, 'raw')}: {ids} ids, {splits} splits "
          f"({time.time() - t0:.1f}s)")
    return True


def spot_decode(tracklets, label, k=3):
    """Decode the first two frames of the first ``k`` tracklets at 256x128;
    returns their shapes and the routes that decoded them."""
    from ..data import jpeg

    t0 = time.time()
    shapes, routes = [], set()
    for frames, _pid, _camid in tracklets[:k]:
        if isinstance(frames, (list, tuple)):
            for f in frames[:2]:
                img, route = jpeg.decode_route(f, 256, 128)
                if img.shape != (256, 128, 3):
                    raise SystemExit(f"{f} decoded to {img.shape}, not (256, 128, 3)")
                shapes.append(img.shape)
                routes.add(route)
    dt = time.time() - t0
    route = "+".join(sorted(routes)) or "no"
    why = "" if jpeg.native_available() else f" (the native routine did not build: {jpeg.NATIVE_INFO['error']})"
    print(f"  {label}: decoded {len(shapes)} frames through the {route} path ({dt:.2f}s){why}")
    return shapes, routes


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dataset", choices=list(EXPECTED))
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--split", type=int, default=0)
    ap.add_argument("--seq_len", type=int, default=8)
    ap.add_argument("--seq_srd", type=int, default=4)
    args = ap.parse_args(argv)

    root = osp.abspath(args.data_dir)
    check_layout(args.dataset, root)

    from ..data import jpeg
    from ..data.catalogs import get_sequence

    sequence = args.dataset in ("ilidsvidsequence", "prid2011sequence")
    prepared = prepare_sequence(args.dataset, root) if sequence else False
    print(f"building {args.dataset} catalog (writes JSON split caches) ...")
    t0 = time.time()
    if sequence:
        ds = get_sequence(args.dataset, root, split_id=args.split, seq_len=args.seq_len, seq_srd=args.seq_srd)
        splits = [("trainval", ds.trainval), ("query", ds.query), ("gallery", ds.gallery)]
    else:
        ds = get_sequence(args.dataset, root)
        splits = [("train", ds.train), ("query", ds.query), ("gallery", ds.gallery)]
    catalog_s = time.time() - t0
    print(f"catalog ok in {catalog_s:.1f}s")

    shapes, routes = [], set()
    for label, items in splits:
        if not items:
            raise SystemExit(f"split {label!r} is empty — check the metadata files")
        got, used = spot_decode(items, label)
        shapes += got
        routes |= used

    recipe = RECIPES[args.dataset].format(root=root)
    print("\nready. reference-parity run:")
    print(recipe)
    print(CLOSING)
    return {"root": root, "prepared": prepared, "catalog_seconds": catalog_s,
            "splits": {label: len(items) for label, items in splits}, "decoded_shapes": shapes,
            "routes": sorted(routes), "native_error": jpeg.NATIVE_INFO["error"], "recipe": recipe}


if __name__ == "__main__":
    main()
