"""Console/file tee logger and scalar metric writer (a copy of
``grl_tpu/utils/logging.py``).

``Logger`` mirrors stdout into a file, flushed on every write so a log
followed with ``tail -f`` survives a hard kill. ``ScalarWriter`` writes
JSONL scalars (one ``{tag, step, value}`` per line); TensorBoard event
files via tensorboardX only when asked for.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import sys


class Logger:
    def __init__(self, fpath=None):
        self.console = sys.stdout
        self.file = None
        if fpath is not None:
            os.makedirs(osp.dirname(fpath) or ".", exist_ok=True)
            self.file = open(fpath, "w")

    def __del__(self):
        self.close()

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()

    def write(self, msg):
        try:
            self.console.write(msg)
        except OSError:
            # a dead terminal or broken stdout pipe must not take the run
            # down, least of all inside the SIGTERM handler's print
            pass
        if self.file is not None:
            self.file.write(msg)
            self.file.flush()

    def flush(self):
        try:
            self.console.flush()
        except OSError:
            pass
        if self.file is not None:
            self.file.flush()
            os.fsync(self.file.fileno())

    def close(self):
        try:
            self.console.flush()
        except OSError:
            pass
        if self.file is not None:
            self.file.close()
            self.file = None


class ScalarWriter:
    """Append-only JSONL scalar stream, ``logdir/scalars.jsonl``.

    ``tensorboard=True`` also writes TensorBoard event files (tensorboardX,
    imported only then); ``wipe=True`` first removes stale event files and
    the scalar stream from ``logdir``.
    """

    def __init__(self, logdir, tensorboard=False, wipe=False):
        os.makedirs(logdir, exist_ok=True)
        if wipe:
            for name in os.listdir(logdir):
                if name.startswith("events.out.tfevents") or name == "scalars.jsonl":
                    os.remove(osp.join(logdir, name))
        self.path = osp.join(logdir, "scalars.jsonl")
        self._f = open(self.path, "a")
        self._tb = None
        if tensorboard:
            from tensorboardX import SummaryWriter

            self._tb = SummaryWriter(logdir)

    def add_scalar(self, tag, value, step):
        self._f.write(json.dumps({"tag": tag, "step": int(step), "value": float(value)}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def flush(self):
        self._f.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
