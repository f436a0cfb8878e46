"""Write a small dataset in DukeMTMC-VideoReID's exact on-disk layout
(counterpart of ``tools/make_fake_duke.py``).

The other primary dataset beside ``make_fake_mars``: real JPEGs under
``root/{train,query,gallery}/<pid>/<tracklet>/``, with frame names in both
formats the reference parses (odd pids the old ``0001C6F0099X...jpg``,
even pids the new ``0001_C6_F0099_X...jpg``; reference
reid/dataset/duke.py:140-146), so the camera-id and F-index parsing runs
end to end. Each tracklet's frames are written in a shuffled order, which
the catalog's F-index ordering must undo.

The draws come from ``np.random.RandomState(seed)`` in grl_tpu's order, so
the same arguments write the same JPEG bytes as grl_tpu's tool. A host
tool: it needs no card.

    python3 -m grl_tpu_torch.tools.make_fake_duke /tmp/fakeduke --train-ids 8 --test-ids 4
    python3 -m grl_tpu_torch.cli.train -d duke --data-dir /tmp/fakeduke ...
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np

from .make_fake_mars import count_files


def make_fake_duke(root, train_ids=4, test_ids=3, cams=2, frames_range=(12, 20), height=128, width=64, seed=0):
    """Write the dataset under ``root`` and return its absolute path.

    ``train/<pid>``: one tracklet per camera. Test pids have one query
    tracklet (camera 1) and one gallery tracklet per camera, so every query
    has a cross-camera match."""
    from PIL import Image

    from ..data.catalogs.synthetic import _template

    rng = np.random.RandomState(seed)
    root = osp.abspath(root)
    all_ids = list(range(1, train_ids + test_ids + 1))
    templates = {pid: _template(rng, height, width) for pid in all_ids}

    def frame_name(pid, cam, f):
        if pid % 2:  # old format: the camera id is name[5]
            return f"{pid:04d}C{cam}F{f:04d}X{f:05d}.jpg"
        return f"{pid:04d}_C{cam}_F{f:04d}_X{f:05d}.jpg"  # new: name[6]

    def write_tracklet(split, pid, cam, tid):
        tdir = osp.join(root, split, f"{pid:04d}", f"{tid:04d}")
        os.makedirs(tdir, exist_ok=True)
        tint = 0.9 + 0.2 * (cam - 1) / max(cams - 1, 1)
        n = rng.randint(*frames_range)
        for f in rng.permutation(n):  # shuffled write order; the catalog re-sorts
            img = np.clip((templates[pid] * tint + 0.08 * rng.randn(height, width, 3)) * 255, 0, 255).astype(np.uint8)
            Image.fromarray(img).save(osp.join(tdir, frame_name(pid, cam, int(f) + 1)))

    for pid in all_ids[:train_ids]:
        for cam in range(1, cams + 1):
            write_tracklet("train", pid, cam, cam)
    for pid in all_ids[train_ids:]:
        write_tracklet("query", pid, 1, 1)
        for cam in range(1, cams + 1):
            write_tracklet("gallery", pid, cam, cam)
    return root


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out")
    ap.add_argument("--train-ids", type=int, default=4)
    ap.add_argument("--test-ids", type=int, default=3)
    ap.add_argument("--cams", type=int, default=2)
    ap.add_argument("--frames", type=int, nargs=2, default=(12, 20))
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    root = make_fake_duke(args.out, train_ids=args.train_ids, test_ids=args.test_ids, cams=args.cams,
                          frames_range=tuple(args.frames), height=args.height, width=args.width, seed=args.seed)
    print(f"wrote fake DukeMTMC-VideoReID ({count_files(root)} files) to {root}")
    print(f"try: python -m grl_tpu_torch.cli.train -d duke --data-dir {root} "
          "--tiny -b 4 --seq_len 4 --epochs 2 --logs-dir /tmp/fakeduke_run")
    return root


if __name__ == "__main__":
    main()
