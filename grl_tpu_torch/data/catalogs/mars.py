"""MARS tracklet catalog (a copy of ``grl_tpu/data/catalogs/mars.py``; the
split caches are grl_tpu's JSON, so either package reads the other's).

Parses the official MARS metadata — ``info/{train,test}_name.txt``,
``info/tracks_{train,test}_info.mat``, ``info/query_IDX.mat`` — into
tracklet tuples ``(img_paths, pid, camid)`` with train-pid relabeling, junk
(-1) filtering, and per-tracklet person/camera consistency checks, caching
splits as JSON. Semantics follow reference reid/dataset/mars.py:13-234 with
two deliberate fixes: the dataset root is a constructor argument (the
reference hardcodes an absolute home path, mars.py:14) and query tracklets
excluded from the gallery are computed positionally.
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from ...utils.serialization import read_json, write_json
from .synthetic import InfoStruct


class Mars:
    def __init__(self, root, min_seq_len=0, use_cache=True):
        self.root = root
        info = osp.join(root, "info")
        self._check_files(
            root,
            osp.join(info, "train_name.txt"),
            osp.join(info, "test_name.txt"),
            osp.join(info, "tracks_train_info.mat"),
            osp.join(info, "tracks_test_info.mat"),
            osp.join(info, "query_IDX.mat"),
        )
        from scipy.io import loadmat

        train_names = self._read_names(osp.join(info, "train_name.txt"))
        test_names = self._read_names(osp.join(info, "test_name.txt"))
        track_train = loadmat(osp.join(info, "tracks_train_info.mat"))["track_train_info"]
        track_test = loadmat(osp.join(info, "tracks_test_info.mat"))["track_test_info"]
        query_idx = loadmat(osp.join(info, "query_IDX.mat"))["query_IDX"].squeeze() - 1
        query_idx = np.atleast_1d(query_idx)

        track_query = track_test[query_idx, :]
        gallery_mask = np.ones(track_test.shape[0], dtype=bool)
        gallery_mask[query_idx] = False
        track_gallery = track_test[gallery_mask, :]

        # non-default min_seq_len gets its own cache files: the split
        # content depends on it, and a stale default-keyed cache would be
        # silently returned otherwise
        def cache(n):
            if not use_cache:
                return None
            if min_seq_len:
                n = n.replace(".json", f"_msl{min_seq_len}.json")
            return osp.join(root, n)

        self.train, self.num_train_pids, train_imgs, _, _ = self._process(
            train_names, track_train, "bbox_train", relabel=True,
            min_seq_len=min_seq_len, json_path=cache("split_train.json"),
        )
        self.query, self.num_query_pids, query_imgs, q_pid, q_camid = self._process(
            test_names, track_query, "bbox_test", relabel=False,
            min_seq_len=min_seq_len, json_path=cache("split_query.json"),
        )
        self.gallery, self.num_gallery_pids, gallery_imgs, g_pid, g_camid = self._process(
            test_names, track_gallery, "bbox_test", relabel=False,
            min_seq_len=min_seq_len, json_path=cache("split_gallery.json"),
        )

        self.queryinfo = InfoStruct()
        self.queryinfo.pid = q_pid
        self.queryinfo.camid = q_camid
        self.queryinfo.tranum = query_imgs
        self.galleryinfo = InfoStruct()
        self.galleryinfo.pid = g_pid
        self.galleryinfo.camid = g_camid
        self.galleryinfo.tranum = gallery_imgs

        self._print_stats(train_imgs + query_imgs + gallery_imgs)

    # -- helpers ---------------------------------------------------------

    @staticmethod
    def _check_files(*paths):
        for p in paths:
            if not osp.exists(p):
                raise RuntimeError(f"'{p}' is not available")

    @staticmethod
    def _read_names(path):
        with open(path) as f:
            return [line.rstrip() for line in f]

    # bumped when the payload SEMANTICS change (v2: num_pids counts the
    # junk pid -1 like the reference); a stale-version cache is reparsed
    # and rewritten rather than silently returning old-semantics values
    _CACHE_VERSION = 2

    def _process(self, names, meta, home_dir, relabel, min_seq_len, json_path):
        if json_path and osp.exists(json_path):
            split = read_json(json_path)
            if split.get("version") == self._CACHE_VERSION:
                return (
                    [(tuple(paths), pid, cam) for paths, pid, cam in split["tracklets"]],
                    split["num_pids"],
                    split["num_imgs_per_tracklet"],
                    split["pids"],
                    split["camid"],
                )

        pid_list = sorted(set(meta[:, 2].tolist()))
        # the reference counts the junk pid (-1) in num_pids when present
        # (mars.py:144,183-184 — its real-MARS gallery banner says 622
        # because of it) even though junk tracklets are skipped below;
        # match the count for diffable stats, but keep -1 OUT of the
        # relabel map (labels must stay 0..n_valid-1 for the OIM lut)
        num_pids = len(pid_list)
        if -1 in pid_list:
            pid_list.remove(-1)
        pid2label = {pid: label for label, pid in enumerate(pid_list)}

        tracklets, num_imgs, pids_out, camids_out = [], [], [], []
        for row in meta:
            start, end, pid, camid = (int(v) for v in row)
            if pid == -1:
                continue
            assert 1 <= camid <= 6, f"camid {camid} out of range"
            label = pid2label[pid] if relabel else pid
            camid -= 1
            img_names = names[start - 1 : end]
            assert len({n[:4] for n in img_names}) == 1, \
                "Error: a single tracklet contains different person images"
            assert len({n[5] for n in img_names}) == 1, \
                "Error: images are captured under different cameras!"
            img_paths = tuple(
                osp.join(self.root, home_dir, n[:4], n) for n in img_names
            )
            if len(img_paths) >= min_seq_len:
                tracklets.append((img_paths, label, camid))
                num_imgs.append(len(img_paths))
                # pid/camid lists must stay PARALLEL to the tracklet list
                # (queryinfo/galleryinfo consumers zip them), so filtered
                # tracklets are excluded here too
                pids_out.append(label)
                camids_out.append(camid)

        if json_path:
            payload = {
                "version": self._CACHE_VERSION,
                "tracklets": tracklets,
                "num_tracklets": len(tracklets),
                "num_pids": num_pids,
                "num_imgs_per_tracklet": num_imgs,
                "pids": pids_out,
                "camid": camids_out,
            }
            try:
                write_json(payload, json_path)
            except OSError as e:
                # read-only dataset mounts are common; the cache is an
                # optimization, not a requirement
                print(f"MARS: split cache not written ({e}); continuing uncached")
        return tracklets, num_pids, num_imgs, pids_out, camids_out

    def _print_stats(self, num_imgs):
        print("=> MARS loaded")
        print("Dataset statistics:")
        print("  ------------------------------")
        print("  subset   | # ids | # tracklets")
        print("  ------------------------------")
        print(f"  train    | {self.num_train_pids:5d} | {len(self.train):8d}")
        print(f"  query    | {self.num_query_pids:5d} | {len(self.query):8d}")
        print(f"  gallery  | {self.num_gallery_pids:5d} | {len(self.gallery):8d}")
        print("  ------------------------------")
        if num_imgs:
            print(
                f"  number of images per tracklet: {min(num_imgs)} ~ {max(num_imgs)}, "
                f"average {np.mean(num_imgs):.1f}"
            )
