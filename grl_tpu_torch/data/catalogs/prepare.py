"""Raw-download preparation for iLIDS-VID and PRID-2011 (a copy of
``grl_tpu/data/catalogs/prepare.py``).

Reproduces the reference's extract-and-relayout step (reference
reid/dataset/ilidsvidsequence.py:70-196, prid2011sequence.py:70-200):
starting from the published tarballs (or already-extracted trees) under
``root/raw``, it builds the canonical layout the catalogs consume —

- ``root/images/{pid:08d}_{cam:02d}_{seq:04d}.png`` frame files,
- ``root/others/...`` optical-flow companions (when a flow archive is
  present; the reference *requires* its Farneback flow tar, here flow is
  optional since the live GRL model consumes RGB only),
- ``root/meta.json`` with per-pid/per-cam image lists,
- ``root/splits.json``: iLIDS-VID's 10 fixed splits from the published
  ``train_test_splits_ilidsvid.mat`` (ls_set), PRID-2011's 20 random
  halves.

Intentional divergences from the reference, which double-copies every
frame through a temp directory and (PRID) computes ``permutation(num)-1``
producing an invalid -1 pid in every random split: files are copied
once, and the PRID split is a seeded permutation of [0, num).
"""

from __future__ import annotations

import os
import os.path as osp
import re
import shutil
import tarfile
from glob import glob

import numpy as np

from ...utils.serialization import write_json


def _extract(tar_path, out_dir, sentinel):
    """Extract unless a completion marker exists.

    The sentinel directory alone cannot be the guard: tar creates the
    top-level directory at the START of extraction, so a killed run
    would be skipped on retry and the partial tree silently accepted.
    A ``.extracted`` marker written only AFTER ``extractall`` returns is
    the completion witness; an interrupted extraction is re-run."""
    marker = osp.join(out_dir, f".extracted_{sentinel}")
    if osp.isdir(osp.join(out_dir, sentinel)) and osp.exists(marker):
        return
    os.makedirs(out_dir, exist_ok=True)
    with tarfile.open(tar_path) as tar:
        tar.extractall(out_dir, filter="data")  # no path traversal
    try:
        with open(marker, "w") as f:
            f.write("ok\n")
    except OSError:
        pass  # extraction succeeded; the marker only skips future re-runs


def _relayout(frame_lists, out_dir):
    """frame_lists: {pid: [cam0_paths, cam1_paths]} with pids dense-ordered.
    Copies frames to canonical names; returns the meta identities list."""
    os.makedirs(out_dir, exist_ok=True)
    identities = []
    for pid, cams in enumerate(frame_lists):
        ident = []
        for cam, paths in enumerate(cams):
            names = []
            for i, src in enumerate(paths):
                name = f"{pid:08d}_{cam:02d}_{i:04d}.png"
                shutil.copy(src, osp.join(out_dir, name))
                names.append(name)
            ident.append(names)
        identities.append(ident)
    return identities


def _gather_ilids(seq_dir):
    """i-LIDS-VID/sequences/cam{1,2}/person***/*.png -> per-pid/cam lists."""
    by_pid = {}
    for fpath in sorted(glob(osp.join(seq_dir, "*", "*", "*.png"))):
        fname = osp.basename(fpath)
        m = re.match(r"cam(\d+)_person(\d+)", fname)
        if not m:
            continue
        cam, pid = int(m.group(1)) - 1, int(m.group(2)) - 1
        by_pid.setdefault(pid, [[], []])[cam].append(fpath)
    return [by_pid[p] for p in sorted(by_pid) if by_pid[p] != [[], []]]


def _gather_prid(shot_dir, max_pid=200):
    """prid_2011/multi_shot/cam_{a,b}/person_****/*.png -> per-pid/cam lists."""
    by_pid = {}
    for fpath in sorted(glob(osp.join(shot_dir, "*", "*", "*.png"))):
        parts = fpath.split(os.sep)
        cam = 0 if parts[-3] == "cam_a" else 1
        pid = int(parts[-2].split("_")[-1])
        if pid > max_pid:  # reference caps at 200 ids (prid2011sequence.py:133)
            continue
        by_pid.setdefault(pid - 1, [[], []])[cam].append(fpath)
    return [by_pid[p] for p in sorted(by_pid) if by_pid[p] != [[], []]]


def _write_meta(root, name, identities):
    write_json(
        {"name": name, "shot": "sequence", "num_cameras": 2, "identities": identities},
        osp.join(root, "meta.json"),
    )


def prepare_ilidsvid(root, image_tar=None, flow_tar=None):
    """Build the canonical iLIDS-VID layout under ``root``.

    Looks for ``root/raw/iLIDS-VID.tar`` (and optional flow tar) or an
    already-extracted ``root/raw/iLIDS-VID`` tree.
    """
    raw = osp.join(root, "raw")
    exdir = osp.join(raw, "iLIDS-VID")
    tar_path = image_tar or osp.join(raw, "iLIDS-VID.tar")
    if not osp.isdir(osp.join(exdir, "i-LIDS-VID")):
        if not osp.isfile(tar_path):
            raise RuntimeError(f"missing raw data: {tar_path} (or extracted {exdir})")
        _extract(tar_path, exdir, "i-LIDS-VID")

    identities = _relayout(
        _gather_ilids(osp.join(exdir, "i-LIDS-VID", "sequences")), osp.join(root, "images")
    )
    _write_meta(root, "iLIDS-sequence", identities)

    flow_tar = flow_tar or osp.join(raw, "Farneback.tar")
    flow_dir = osp.join(raw, "Farneback")
    if osp.isfile(flow_tar) or osp.isdir(flow_dir):
        if not osp.isdir(osp.join(flow_dir, "Farneback")):
            _extract(flow_tar, flow_dir, "Farneback")
        _relayout(
            _gather_ilids(osp.join(flow_dir, "Farneback")), osp.join(root, "others")
        )

    # 10 fixed splits from the published .mat (ilidsvidsequence.py:181-195)
    from scipy.io import loadmat

    matpath = osp.join(exdir, "i-LIDS-VID", "train-test people splits",
                       "train_test_splits_ilidsvid.mat")
    if not osp.isfile(matpath):
        matpath = osp.join(exdir, "train-test people splits",
                           "train_test_splits_ilidsvid.mat")
    person_list = loadmat(matpath)["ls_set"]
    num = len(identities)
    splits = []
    for i in range(person_list.shape[0]):
        pids = (np.asarray(person_list[i]).ravel() - 1).tolist()
        if len(pids) != num or (pids and (min(pids) < 0 or max(pids) >= num)):
            raise RuntimeError(
                f"split {i}: .mat lists {len(pids)} pids in [{min(pids)}, "
                f"{max(pids)}] but {num} identities were gathered — the raw "
                "tree is missing person directories (dense numbering assumed)"
            )
        splits.append({
            "trainval": sorted(pids[: num // 2]),
            "query": sorted(pids[num // 2:]),
            "gallery": sorted(pids[num // 2:]),
        })
    write_json(splits, osp.join(root, "splits.json"))
    return len(identities), len(splits)


def prepare_prid2011(root, image_tar=None, flow_tar=None, num_splits=20, seed=0):
    """Build the canonical PRID-2011 layout under ``root``."""
    raw = osp.join(root, "raw")
    exdir = osp.join(raw, "prid_2011")
    tar_path = image_tar or osp.join(raw, "prid_2011.tar")
    if not osp.isdir(osp.join(exdir, "prid_2011")):
        if not osp.isfile(tar_path):
            raise RuntimeError(f"missing raw data: {tar_path} (or extracted {exdir})")
        _extract(tar_path, exdir, "prid_2011")

    identities = _relayout(
        _gather_prid(osp.join(exdir, "prid_2011", "multi_shot")), osp.join(root, "images")
    )
    _write_meta(root, "prid-sequence", identities)

    flow_tar = flow_tar or osp.join(raw, "prid2011flow.tar")
    flow_dir = osp.join(raw, "prid2011flow")
    if osp.isfile(flow_tar) or osp.isdir(flow_dir):
        if not osp.isdir(osp.join(flow_dir, "prid2011flow")):
            _extract(flow_tar, flow_dir, "prid2011flow")
        _relayout(
            _gather_prid(osp.join(flow_dir, "prid2011flow")), osp.join(root, "others")
        )

    # 20 seeded random half-splits (prid2011sequence.py:190-200, with its
    # off-by-one -1 pid bug fixed)
    rng = np.random.RandomState(seed)
    num = len(identities)
    splits = []
    for _ in range(num_splits):
        pids = rng.permutation(num).tolist()
        splits.append({
            "trainval": pids[: num // 2],
            "query": pids[num // 2:],
            "gallery": pids[num // 2:],
        })
    write_json(splits, osp.join(root, "splits.json"))
    return len(identities), len(splits)
