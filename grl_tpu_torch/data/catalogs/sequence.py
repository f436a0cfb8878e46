"""Windowed sequence catalogs: iLIDS-VID and PRID-2011 (a copy of
``grl_tpu/data/catalogs/sequence.py``).

The reference handles these two through a ``Datasequence`` base
(reid/data/datasequence.py:8-96) operating on a re-laid-out directory
(``root/images`` with canonical ``{pid:08d}_{cam:02d}_{seq:04d}.jpg``
names, a ``meta.json`` of per-pid/per-cam image lists, and a
``splits.json`` of trainval/test pid splits), sliding
``(seq_len, seq_srd)`` windows over each pid/cam image list
(datasequence.py:8-21) and building per-camera query (cam 0) / gallery
(cam 1) window sets at eval (ilidsvidsequence.py:196-214).

Here each window becomes a standard tracklet tuple ``(img_paths, pid,
camid)``, so downstream sampling/loading is uniform with MARS/Duke. The
raw-tar extraction step of the reference (ilidsvidsequence.py:70-177) is
out of scope — datasets must be in the extracted layout above (a helpful
error says so). Optical-flow companions (``root/others``) are exposed via
``flow_paths_for`` for pipelines that want the reference's two-modality
input; the live GRL model consumes RGB only.
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from ...utils.serialization import read_json
from .synthetic import InfoStruct


def _windows(n, seq_len, seq_srd):
    if n == 0:
        # a pid with no frames on this camera (partial extraction, or a
        # genuinely single-camera identity) must yield NO tracklets — a
        # (0, 0) window would become an empty-path tracklet that crashes
        # clip sampling (rrs_grid on zero frames)
        return []
    inds = [(s, s + seq_len) for s in range(0, n - seq_len, seq_srd)]
    return inds if inds else [(0, n)]


class SequenceDataset:
    """Base for extracted iLIDS-VID / PRID-2011 layouts."""

    name = "sequence"

    def __init__(self, root, split_id=0, seq_len=8, seq_srd=4, num_val=0.3, seed=0, verbose=True):
        self.root = root
        if not (
            osp.isdir(osp.join(root, "images"))
            and osp.isfile(osp.join(root, "meta.json"))
            and osp.isfile(osp.join(root, "splits.json"))
        ):
            raise RuntimeError(
                f"{self.name}: expected extracted layout at {root} with images/, "
                "meta.json and splits.json (see reference "
                "reid/dataset/ilidsvidsequence.py:70-177 for the relayout)"
            )
        splits = read_json(osp.join(root, "splits.json"))
        if split_id >= len(splits):
            raise ValueError(f"split_id exceeds total splits {len(splits)}")
        self.split = splits[split_id]
        self.meta = read_json(osp.join(root, "meta.json"))
        identities = self.meta["identities"]

        rng = np.random.RandomState(seed)
        trainval_pids = np.asarray(self.split["trainval"])
        rng.shuffle(trainval_pids)
        n_val = int(round(len(trainval_pids) * num_val)) if isinstance(num_val, float) else num_val
        train_pids = sorted(trainval_pids[: len(trainval_pids) - n_val])
        val_pids = sorted(trainval_pids[len(trainval_pids) - n_val :])

        self.train = self._pluck(identities, train_pids, seq_len, seq_srd)
        self.val = self._pluck(identities, val_pids, seq_len, seq_srd)
        self.trainval = self._pluck(identities, trainval_pids, seq_len, seq_srd)
        self.num_train_pids = len(train_pids)
        self.num_trainval_ids = len(trainval_pids)

        # per-camera eval: query from camera 0, gallery from camera 1
        test_pids = self.split["query"]
        self.query, self.queryinfo = self._pluck_cam(identities, test_pids, seq_len, seq_srd, 0)
        self.gallery, self.galleryinfo = self._pluck_cam(identities, self.split["gallery"], seq_len, seq_srd, 1)

        if verbose:
            print(f"=> {self.name} loaded (split {split_id})")
            print(f"  train    | {self.num_train_pids:5d} ids | {len(self.train):6d} windows")
            print(f"  trainval | {self.num_trainval_ids:5d} ids | {len(self.trainval):6d} windows")
            print(f"  query    | {len(test_pids):5d} ids | {len(self.query):6d} windows")
            print(f"  gallery  | {len(self.split['gallery']):5d} ids | {len(self.gallery):6d} windows")

    # -- helpers ---------------------------------------------------------

    def _paths(self, identities, pid, cam, start, end):
        return tuple(
            osp.join(self.root, "images", identities[pid][cam][i]) for i in range(start, end)
        )

    def flow_paths_for(self, img_paths):
        return tuple(p.replace(osp.join(self.root, "images"), osp.join(self.root, "others"))
                     for p in img_paths)

    def _pluck(self, identities, pids, seq_len, seq_srd):
        out = []
        for label, pid in enumerate(pids):
            for cam, cam_images in enumerate(identities[pid]):
                for s, e in _windows(len(cam_images), seq_len, seq_srd):
                    out.append((self._paths(identities, pid, cam, s, e), label, cam))
        return out

    def _pluck_cam(self, identities, pids, seq_len, seq_srd, cam):
        out, per_id, cam_id, tra_num = [], [], [], []
        for label, pid in enumerate(pids):
            cam_images = identities[pid][cam]
            inds = _windows(len(cam_images), seq_len, seq_srd)
            for s, e in inds:
                out.append((self._paths(identities, pid, cam, s, e), label, cam))
            per_id.append(pid)
            cam_id.append(cam)
            tra_num.append(len(inds))
        info = InfoStruct()
        info.pid = per_id
        info.camid = cam_id
        info.tranum = tra_num
        return out, info


class iLIDSVIDSequence(SequenceDataset):
    name = "ilidsvidsequence"


class PRID2011Sequence(SequenceDataset):
    name = "prid2011sequence"
