"""Host-side clip pipeline for in-memory uint8 sources, with prefetch.

A copy of ``grl_tpu/data/loader.py``'s ``ClipDataset``/``ClipLoader`` for
tracklets whose frames are uint8 arrays (the synthetic catalog and
pre-decoded frames): a thread-pool stage gathers frames and a prefetch
thread hands uint8 batches to the caller, which uploads, augments and
normalizes them on the device. Training batches come from a sampler
(``RandomPairSampler``) with ``drop_last``. JPEG path sources, the real
catalogs and ``get_data`` come with the data-plane slice.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .sampling import dense_indices, random_window_indices, rrs_test_indices, rrs_train_indices


def _frame(source, index, height, width):
    if not isinstance(source, np.ndarray):
        raise TypeError(
            "grl_tpu_torch's loader takes in-memory uint8 frame arrays; JPEG "
            "path sources are not ported yet"
        )
    frame = source[index]
    if frame.shape[0] != height or frame.shape[1] != width:
        from PIL import Image

        frame = np.asarray(Image.fromarray(frame).resize((width, height), Image.BILINEAR))
    return frame


class ClipDataset:
    """Catalog + sampling mode -> per-index uint8 clip arrays.

    sample modes: 'rrs_train', 'rrs_test', 'dense', 'random'.
    """

    def __init__(self, tracklets, seq_len=8, sample="rrs_train", height=256, width=128, seed=0):
        self.tracklets = tracklets
        self.seq_len = seq_len
        self.sample = sample
        self.height = height
        self.width = width
        self.seed = seed

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

    def _clip(self, source, idx):
        return np.stack([_frame(source, int(i), self.height, self.width) for i in idx])

    def get(self, index, epoch=0):
        source, pid, camid = self.tracklets[index]
        n = source.shape[0]
        if self.sample == "rrs_train":
            idx = rrs_train_indices(n, self.seq_len, self._item_rng(index, epoch))
        elif self.sample == "rrs_test":
            idx = rrs_test_indices(n, self.seq_len)
        elif self.sample == "random":
            idx = random_window_indices(n, self.seq_len, self._item_rng(index, epoch))
        elif self.sample == "dense":
            grid = dense_indices(n, self.seq_len)
            return np.stack([self._clip(source, row) for row in grid]), pid, camid
        else:
            raise KeyError(f"Unknown sample method: {self.sample}")
        return self._clip(source, idx), pid, camid


class ClipLoader:
    """Batched iterator with threaded gather and prefetch.

    Indices come from ``sampler`` when given, else catalog order (shuffled
    with a ``RandomState(seed)`` when ``shuffle``). ``drop_last`` drops a
    short last batch; ``max_batches`` caps the batches of an epoch.
    Yields ``(clips uint8 (b, S, h, w, 3), pids (b,), camids (b,))``;
    with ``sample='dense'`` batch_size must be 1 and clips are
    ``(n_clips, S, h, w, 3)``.
    """

    def __init__(self, dataset: ClipDataset, batch_size=16, sampler=None, shuffle=False,
                 drop_last=False, workers=4, prefetch=2, seed=0, max_batches=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.workers = max(workers, 1)
        self.prefetch = prefetch
        self.rng = np.random.RandomState(seed)
        self.max_batches = max_batches
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
