"""DukeMTMC-VideoReID tracklet catalog (a copy of
``grl_tpu/data/catalogs/duke.py``; the split caches are grl_tpu's JSON).

Directory layout ``root/{train,query,gallery}/<pid>/<tracklet>/*.jpg``.
Semantics follow reference reid/dataset/duke.py:18-235: frame paths are
ordered by their F-index (tolerating missing indices), camera ids parse
from both old (``0001C6F0099X...jpg``) and new (``0001_C6_F0099_X...jpg``)
filename formats, splits cache to JSON, and a dense variant slices long
tracklets into ``sampling_step``-frame sub-tracklets. Root is an argument
(reference hardcodes it, duke.py:30).
"""

from __future__ import annotations

import glob
import os.path as osp
import re

import numpy as np

from ...utils.serialization import read_json, write_json

_FRAME_RE = re.compile(r"F(\d{4})")


def _camid_from_name(name):
    if "_" not in name:
        return int(name[5]) - 1
    return int(name[6]) - 1


class DukeMTMCVidReID:
    def __init__(self, root, min_seq_len=0, dense_sampling_step=32, use_cache=True, verbose=True):
        self.root = root
        self.min_seq_len = min_seq_len
        for sub in ("train", "query", "gallery"):
            if not osp.exists(osp.join(root, sub)):
                raise RuntimeError(f"'{osp.join(root, sub)}' is not available")

        # cache files are keyed by the parameters the split content
        # depends on (a stale default-keyed cache would silently win)
        def cache(n):
            if not use_cache:
                return None
            if min_seq_len:
                n = n.replace(".json", f"_msl{min_seq_len}.json")
            return osp.join(root, n)

        dense_name = (
            "split_train_dense.json" if dense_sampling_step == 32
            else f"split_train_dense_s{dense_sampling_step}.json"
        )
        self.train, self.num_train_pids, n_train = self._process_dir(
            osp.join(root, "train"), cache("split_train.json"), relabel=True
        )
        self.train_dense, _, _ = self._process_dir(
            osp.join(root, "train"), cache(dense_name), relabel=True,
            sampling_step=dense_sampling_step,
        )
        self.query, self.num_query_pids, n_query = self._process_dir(
            osp.join(root, "query"), cache("split_query.json"), relabel=False
        )
        self.gallery, self.num_gallery_pids, n_gallery = self._process_dir(
            osp.join(root, "gallery"), cache("split_gallery.json"), relabel=False
        )

        if verbose:
            print("=> DukeMTMC-VideoReID loaded")
            print(f"  train   | {self.num_train_pids:5d} ids | {len(self.train):6d} tracklets")
            print(f"  query   | {self.num_query_pids:5d} ids | {len(self.query):6d} tracklets")
            print(f"  gallery | {self.num_gallery_pids:5d} ids | {len(self.gallery):6d} tracklets")

    def _process_dir(self, dir_path, json_path, relabel, sampling_step=0):
        if json_path and osp.exists(json_path):
            split = read_json(json_path)
            tracklets = [(tuple(paths), pid, cam) for paths, pid, cam in split["tracklets"]]
            return tracklets, split["num_pids"], split["num_imgs_per_tracklet"]

        pdirs = sorted(d for d in glob.glob(osp.join(dir_path, "*")) if osp.isdir(d))
        pid2label = {int(osp.basename(d)): i for i, d in enumerate(pdirs)}

        tracklets, num_imgs = [], []
        for pdir in pdirs:
            pid = int(osp.basename(pdir))
            label = pid2label[pid] if relabel else pid
            for tdir in sorted(glob.glob(osp.join(pdir, "*"))):
                raw = glob.glob(osp.join(tdir, "*.jpg"))
                if len(raw) < self.min_seq_len:
                    continue
                # order frames by F-index; tolerate gaps (duke.py:132-139)
                by_index = {}
                for p in raw:
                    m = _FRAME_RE.search(osp.basename(p))
                    if m:
                        by_index[int(m.group(1))] = p
                img_paths = tuple(by_index[i] for i in sorted(by_index))
                if not img_paths:
                    continue
                camid = _camid_from_name(osp.basename(img_paths[0]))
                num_imgs.append(len(img_paths))
                if sampling_step <= 0 or len(img_paths) < sampling_step:
                    tracklets.append((img_paths, label, camid))
                else:
                    n = len(img_paths) // sampling_step
                    for i in range(n):
                        chunk = (
                            img_paths[i * sampling_step :]
                            if i == n - 1
                            else img_paths[i * sampling_step : (i + 1) * sampling_step]
                        )
                        tracklets.append((chunk, label, camid))

        if json_path:
            try:
                write_json(
                    {
                        "tracklets": tracklets,
                        "num_tracklets": len(tracklets),
                        "num_pids": len(pid2label),
                        "num_imgs_per_tracklet": num_imgs,
                    },
                    json_path,
                )
            except OSError as e:
                # read-only dataset mounts: the cache is an optimization
                print(f"Duke: split cache not written ({e}); continuing uncached")
        return tracklets, len(pid2label), num_imgs
