"""Host-side clip pipeline: decode -> resize -> batch, with prefetch
(counterpart of ``grl_tpu/data/loader.py``).

Tracklet frames are either in-memory uint8 arrays (the synthetic catalog,
pre-decoded frames) or tuples of image paths (the real catalogs), decoded
by ``data/jpeg.py``. A thread-pool stage decodes and gathers frames and a
prefetch thread hands uint8 batches to the caller, which uploads,
augments and normalizes them on the device. Training batches come from a
sampler (``RandomPairSampler``) with ``drop_last``. ``get_data`` builds a
catalog's loaders as grl_tpu's does, and for a rank of a data-parallel
group: its identity shard of the train catalog (``process_shard``), its
slice of every global batch (``batch_slice``), or its stripe of the eval
catalogs (``eval_stripe``).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .sampling import (RandomPairSampler, dense_indices, random_window_indices, rrs_test_indices,
                       rrs_train_indices)


def _frame(source, index, height, width):
    if not isinstance(source, np.ndarray):
        from .jpeg import decode_resize

        return decode_resize(source[index], height, width)
    frame = source[index]
    if frame.shape[0] != height or frame.shape[1] != width:
        from PIL import Image

        frame = np.asarray(Image.fromarray(frame).resize((width, height), Image.BILINEAR))
    return frame


def _num_frames(source):
    return source.shape[0] if isinstance(source, np.ndarray) else len(source)


class ClipDataset:
    """Catalog + sampling mode -> per-index uint8 clip arrays.

    sample modes: 'rrs_train', 'rrs_test', 'dense', 'random'.

    ``flow_map`` (optional) maps a tracklet's frame source to its
    optical-flow companion (``SequenceDataset.flow_paths_for``); each frame
    then carries 6 channels, RGB then flow, in every sample mode.
    """

    def __init__(self, tracklets, seq_len=8, sample="rrs_train", height=256, width=128, seed=0,
                 flow_map=None):
        self.tracklets = tracklets
        self.seq_len = seq_len
        self.sample = sample
        self.height = height
        self.width = width
        self.seed = seed
        self.flow_map = flow_map

    def __len__(self):
        return len(self.tracklets)

    def _item_rng(self, index, epoch):
        """Deterministic RNG per (seed, epoch, tracklet) — splitmix64 over the
        packed triple, as grl_tpu draws it, so both packages sample the same
        frames."""
        x = (self.seed * (2**42) + epoch * (2**28) + index) & 0xFFFFFFFFFFFFFFFF
        x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        return np.random.RandomState((x ^ (x >> 31)) % (2**31 - 1))

    def _clip(self, source, flow, idx):
        frames = [_frame(source, int(i), self.height, self.width) for i in idx]
        if flow is not None:
            frames = [np.concatenate([f, _frame(flow, int(i), self.height, self.width)], axis=-1)
                      for f, i in zip(frames, idx)]
        return np.stack(frames)

    def get(self, index, epoch=0):
        source, pid, camid = self.tracklets[index]
        flow = self.flow_map(source) if self.flow_map is not None else None
        n = _num_frames(source)
        if self.sample == "rrs_train":
            idx = rrs_train_indices(n, self.seq_len, self._item_rng(index, epoch))
        elif self.sample == "rrs_test":
            idx = rrs_test_indices(n, self.seq_len)
        elif self.sample == "random":
            idx = random_window_indices(n, self.seq_len, self._item_rng(index, epoch))
        elif self.sample == "dense":
            grid = dense_indices(n, self.seq_len)
            return np.stack([self._clip(source, flow, row) for row in grid]), pid, camid
        else:
            raise KeyError(f"Unknown sample method: {self.sample}")
        return self._clip(source, flow, idx), pid, camid


class ClipLoader:
    """Batched iterator with threaded gather and prefetch.

    Indices come from ``sampler`` when given, else catalog order (shuffled
    with a ``RandomState(seed)`` when ``shuffle``). ``drop_last`` drops a
    short last batch; ``max_batches`` caps the batches of an epoch.
    ``batch_slice`` (a ``slice``) loads only those positions of each batch:
    the batches are formed at ``batch_size`` and cut after, so a rank's
    slice of a global batch holds the same clips, byte for byte, as those
    rows of the whole batch (each item's frames are drawn from its index
    and the epoch); ``len()`` is unchanged.
    Yields ``(clips uint8 (b, S, h, w, c), pids (b,), camids (b,))``, c = 3,
    or 6 with flow; with ``sample='dense'`` batch_size must be 1 and clips
    are ``(n_clips, S, h, w, c)``.
    """

    def __init__(self, dataset: ClipDataset, batch_size=16, sampler=None, shuffle=False,
                 drop_last=False, workers=4, prefetch=2, seed=0, max_batches=None, batch_slice=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.workers = max(workers, 1)
        self.prefetch = prefetch
        self.rng = np.random.RandomState(seed)
        self.max_batches = max_batches
        self.batch_slice = batch_slice
        # epoch counter: salts the per-item sampling RNG so rrs_train and
        # random draws differ across epochs
        self._epoch = 0
        if dataset.sample == "dense" and batch_size != 1:
            raise ValueError("dense sampling requires batch_size=1")

    def _indices(self):
        if self.sampler is not None:
            return list(iter(self.sampler))
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            self.rng.shuffle(idx)
        return idx

    def __len__(self):
        # len(sampler), never a pass over it: iterating would consume the
        # sampler's RNG and shift every later epoch's batches
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        n = n // self.batch_size if self.drop_last else -(-n // self.batch_size)
        return n if self.max_batches is None else min(n, self.max_batches)

    def __iter__(self):
        indices = self._indices()
        epoch = self._epoch
        self._epoch += 1
        batches = [indices[i : i + self.batch_size] for i in range(0, len(indices), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        if self.max_batches is not None:
            batches = batches[: self.max_batches]
        if self.batch_slice is not None:
            batches = [batch[self.batch_slice] for batch in batches]

        q = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        err = []

        def produce():
            try:
                with ThreadPoolExecutor(max_workers=self.workers) as pool:
                    for batch in batches:
                        if stop.is_set():
                            break
                        items = list(pool.map(lambda i: self.dataset.get(i, epoch), batch))
                        if self.dataset.sample == "dense":
                            clips = items[0][0]
                        else:
                            clips = np.stack([c for c, _, _ in items])
                        pids = np.asarray([p for _, p, _ in items], np.int32)
                        cams = np.asarray([c for _, _, c in items], np.int32)
                        q.put((clips, pids, cams))
            except BaseException as e:  # noqa: BLE001
                # surfaces in the consumer below instead of leaving it
                # blocked in q.get() behind a dead producer
                err.append(e)
            finally:
                q.put(None)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                yield item
            if err:
                raise RuntimeError("ClipLoader producer failed") from err[0]
        finally:
            stop.set()
            # drain until the producer has exited: it may be blocked in
            # q.put re-filling the queue between checks
            while thread.is_alive():
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
            thread.join()


def get_data(name, root=None, batch_size=16, seq_len=8, seq_srd=4, workers=4, only_eval=False,
             split_id=0, height=256, width=128, eval_batch=30, seed=0, dataset_kwargs=None,
             train_sample="rrs_train", process_shard=False, use_flow=False, eval_stripe=False,
             batch_slice=None):
    """Build ``(dataset, num_classes, train_loader, query_loader,
    gallery_loader)`` as ``grl_tpu/data/loader.py::get_data`` does, for
    mars, duke, ilidsvidsequence, prid2011sequence and synthetic.

    The train loader pairs anchors and positives (``RandomPairSampler``,
    ``drop_last``); evaluation samples dense clips one tracklet at a time
    when ``only_eval``, else one rrs_test clip per tracklet. ``use_flow``
    gives every loader 6-channel RGB|flow clips; only the sequence
    datasets have flow, any other raises ``ValueError``.

    A rank of a group (``parallel``): ``process_shard`` loads this rank's
    identity shard of the train catalog (``shard_catalog``) with
    ``batch_size`` its LOCAL batch, every rank's epoch capped to the
    smallest shard's steps (``min_shard_size``), as grl_tpu's processes;
    ``batch_slice`` loads that slice of every global batch of
    ``batch_size``; ``eval_stripe`` loads this rank's contiguous stripe of
    the query and gallery catalogs (``stripe_catalog``)."""
    from .catalogs import get_sequence

    kwargs = dict(dataset_kwargs or {})
    flow_map = None
    if name in ("ilidsvidsequence", "prid2011sequence"):
        dataset = get_sequence(name, root, split_id=split_id, seq_len=seq_len, seq_srd=seq_srd, **kwargs)
        train_list = dataset.trainval
        num_classes = dataset.num_trainval_ids
        if use_flow:
            flow_map = dataset.flow_paths_for
    elif use_flow:
        raise ValueError(f"{name} has no optical-flow companions (sequence datasets only)")
    elif name == "synthetic":
        dataset = get_sequence(name, **kwargs)
        train_list = dataset.train
        num_classes = dataset.num_train_pids
        height, width = dataset.height, dataset.width
    else:
        dataset = get_sequence(name, root, **kwargs)
        train_list = dataset.train
        num_classes = dataset.num_train_pids

    train_loader = None
    if not only_eval:
        if batch_size % 2 != 0:
            raise ValueError("train batch_size must be even (anchor/positive pairs)")
        max_batches = None
        if process_shard:
            # every rank caps its epoch to the smallest shard's step count
            # (each computes it alike): a rank with more steps would wait
            # forever in the gradient reduction of a step its peers never take
            from ..parallel import min_shard_size, shard_catalog

            max_batches = (2 * min_shard_size(train_list)) // batch_size
            if max_batches == 0:
                raise ValueError(
                    f"multi-host: the smallest identity shard ({min_shard_size(train_list)} tracklets) "
                    f"cannot fill one local batch of {batch_size}; every epoch would run zero steps; "
                    "use fewer ranks or a smaller per-rank batch")
            train_list = shard_catalog(train_list)
        train_loader = ClipLoader(
            ClipDataset(train_list, seq_len, train_sample, height, width, seed=seed, flow_map=flow_map),
            batch_size=batch_size, sampler=RandomPairSampler(train_list, seed=seed), drop_last=True,
            workers=workers, max_batches=max_batches, batch_slice=batch_slice)

    eval_sample = "dense" if only_eval else "rrs_test"
    eval_bs = 1 if only_eval else eval_batch
    query_list, gallery_list = dataset.query, dataset.gallery
    if eval_stripe:
        from ..parallel import stripe_catalog

        query_list, _, _ = stripe_catalog(query_list)
        gallery_list, _, _ = stripe_catalog(gallery_list)
    query_loader, gallery_loader = (
        ClipLoader(ClipDataset(items, seq_len, eval_sample, height, width, flow_map=flow_map), batch_size=eval_bs,
                   workers=workers)
        for items in (query_list, gallery_list))
    return dataset, num_classes, train_loader, query_loader, gallery_loader
