"""Host-side clip pipeline for in-memory uint8 sources, with prefetch.

A copy of ``grl_tpu/data/loader.py``'s ``ClipDataset``/``ClipLoader`` for
tracklets whose frames are uint8 arrays (the synthetic catalog and
pre-decoded frames): a thread-pool stage gathers frames and a
one-batch-ahead prefetch thread hands uint8 batches to the caller, which
uploads and normalizes them on the device. JPEG path sources, the real
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
    """Batched iterator in catalog order, with threaded gather and prefetch.

    Yields ``(clips uint8 (b, S, h, w, 3), pids (b,), camids (b,))``;
    with ``sample='dense'`` batch_size must be 1 and clips are
    ``(n_clips, S, h, w, 3)``.
    """

    def __init__(self, dataset: ClipDataset, batch_size=16, workers=4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.workers = max(workers, 1)
        # epoch counter: salts the per-item sampling RNG so rrs_train and
        # random draws differ across epochs
        self._epoch = 0
        if dataset.sample == "dense" and batch_size != 1:
            raise ValueError("dense sampling requires batch_size=1")

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self):
        epoch = self._epoch
        self._epoch += 1
        n = len(self.dataset)
        batches = [list(range(i, min(i + self.batch_size, n))) for i in range(0, n, self.batch_size)]

        q = queue.Queue(maxsize=2)  # one batch ahead of the consumer, one in hand
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
