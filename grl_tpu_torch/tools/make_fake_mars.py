"""Write a small dataset in MARS's exact on-disk layout (counterpart of
``tools/make_fake_mars.py``).

Real JPEG files under ``bbox_train/<pid4>/<name>`` and ``bbox_test/...``,
the ``info/*.txt`` name lists and the ``tracks_{train,test}_info.mat`` /
``query_IDX.mat`` metadata (reference reid/dataset/mars.py:14-40 formats),
so that ``cli.train -d mars --data-dir <out>`` runs the real data path:
the .mat parse, the junk filter, the JPEG decode (``data/jpeg.py``), the
pair sampler over file tuples, dense evaluation. Frames are per-identity
low-frequency templates with noise and a camera tint (the synthetic
catalog's recipe), so training separates identities.

The draws come from ``np.random.RandomState(seed)`` in grl_tpu's order, so
the same arguments write the same JPEG and ``.txt`` bytes as grl_tpu's
tool, and ``.mat`` files equal under ``scipy.io.loadmat`` (``savemat``
stamps its creation time into the header). A host tool: it needs no card.

    python3 -m grl_tpu_torch.tools.make_fake_mars /tmp/fakemars --train-ids 8 --test-ids 4
    python3 -m grl_tpu_torch.cli.train -d mars --data-dir /tmp/fakemars ...
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np


def make_fake_mars(root, train_ids=4, test_ids=3, cams=2, tracklets_per_id_cam=1, frames_range=(12, 20),
                   height=128, width=64, seed=0, junk_tracklets=1, query_cams=1, test_tracklets_per_id_cam=None):
    """Write the dataset under ``root`` and return its absolute path. pids
    are 1-based as in MARS, ``tracklets_per_id_cam`` tracklets per (pid,
    camera); ``junk_tracklets`` of pid -1 (MARS's ``0000`` directory, which
    the catalog filters) end the test split. Queries are the first tracklet
    of every test pid on cameras 1..``query_cams``; the other cameras stay
    gallery-only, so every query keeps a cross-camera match."""
    from PIL import Image
    from scipy.io import savemat

    from ..data.catalogs.synthetic import _template

    rng = np.random.RandomState(seed)
    root = osp.abspath(root)
    info = osp.join(root, "info")
    os.makedirs(info, exist_ok=True)
    all_ids = list(range(1, train_ids + test_ids + 1))
    templates = {pid: _template(rng, height, width) for pid in all_ids}

    def write_tracklet(split_dir, pid, cam, tid, n_frames):
        """The frame names written."""
        dirname = f"{max(pid, 0):04d}"  # junk pid -1 -> MARS's 0000 directory
        os.makedirs(osp.join(root, split_dir, dirname), exist_ok=True)
        tint = 0.9 + 0.2 * (cam - 1) / max(cams - 1, 1)
        template = templates.get(pid)
        names = []
        for f in range(1, n_frames + 1):
            if template is None:  # junk: noise
                img = rng.randint(0, 255, (height, width, 3)).astype(np.uint8)
            else:
                img = np.clip((template * tint + 0.08 * rng.randn(height, width, 3)) * 255, 0, 255).astype(np.uint8)
            name = f"{dirname}C{cam}T{tid:04d}F{f:03d}.jpg"
            Image.fromarray(img).save(osp.join(root, split_dir, dirname, name))
            names.append(name)
        return names

    def build_split(split_dir, pids, junk, tpic):
        names, rows, start = [], [], 1
        for pid in pids:
            for cam in range(1, cams + 1):
                for t in range(1, tpic + 1):
                    nf = rng.randint(*frames_range)
                    names += write_tracklet(split_dir, pid, cam, t, nf)
                    rows.append([start, start + nf - 1, pid, cam])
                    start += nf
        for _ in range(junk):
            nf = rng.randint(*frames_range)
            names += write_tracklet(split_dir, -1, 1, 1, nf)
            rows.append([start, start + nf - 1, -1, 1])
            start += nf
        return names, np.array(rows, np.int64)

    test_tpic = test_tracklets_per_id_cam or tracklets_per_id_cam
    train_names, train_rows = build_split("bbox_train", all_ids[:train_ids], 0, tracklets_per_id_cam)
    test_names, test_rows = build_split("bbox_test", all_ids[train_ids:], junk_tracklets, test_tpic)
    with open(osp.join(info, "train_name.txt"), "w") as f:
        f.write("\n".join(train_names) + "\n")
    with open(osp.join(info, "test_name.txt"), "w") as f:
        f.write("\n".join(test_names) + "\n")
    savemat(osp.join(info, "tracks_train_info.mat"), {"track_train_info": train_rows})
    savemat(osp.join(info, "tracks_test_info.mat"), {"track_test_info": test_rows})
    # 1-based rows of the queries; query_cams scales their count toward
    # MARS's 1980 at full cardinality
    q_rows = [i + 1 for i, row in enumerate(test_rows)
              if row[2] != -1 and row[3] <= query_cams and (test_tpic == 1 or (i % test_tpic) == 0)]
    savemat(osp.join(info, "query_IDX.mat"), {"query_IDX": np.array([q_rows])})
    return root


def count_files(root):
    return sum(len(files) for _, _, files in os.walk(root))


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
    root = make_fake_mars(args.out, train_ids=args.train_ids, test_ids=args.test_ids, cams=args.cams,
                          frames_range=tuple(args.frames), height=args.height, width=args.width, seed=args.seed)
    print(f"wrote fake MARS ({count_files(root)} files) to {root}")
    print(f"try: python -m grl_tpu_torch.cli.train -d mars --data-dir {root} "
          "--tiny -b 4 --seq_len 4 --epochs 2 --logs-dir /tmp/fakemars_run")
    return root


if __name__ == "__main__":
    main()
