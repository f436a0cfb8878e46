"""Epoch-level training loop on one process (counterpart of
``grl_tpu/engine/trainer.py``).

Per step: upload the uint8 batch, augment it on the device with the
trainer's generator, run the train step. Metrics are read one step late,
so the host never waits on step i before step i+1 is queued. Meters,
prints (every ``print_freq`` steps), the scalar writer's tags and step
numbers, and the returned dict follow grl_tpu; the writer is flushed at
the end of each epoch. A ``stop_event`` ends the epoch at the next step
boundary.

Under a profiler (``utils.profiling.span``) each pass of the loop is a
``trainer.iteration`` span holding ``trainer.data_wait`` (the loader's
``next()``), ``trainer.upload``, ``trainer.augment``, ``trainer.step``
(enqueueing the train step) and ``trainer.read`` (the previous step's
metrics read and written); the pass that finds the loader spent holds only
its ``trainer.data_wait``, and the last step's ``trainer.read`` follows the
loop.

With ``mesh`` (a data-parallel group) the loader yields this rank's
contiguous slice of each global batch. The augmentation draws its randoms
for the whole global batch from the trainer's generator, which every rank
seeds alike, and applies this rank's rows of them: grl_tpu augments the
global array with one key, so the draws are not made per rank. The stop
decision is collective, as grl_tpu's multi-process one: a SIGTERM lands on
ranks at different times, and a rank that stops while its peers take
another step leaves them waiting in that step's reductions forever.
"""

from __future__ import annotations

import itertools
import time

import torch

from .. import resolve_device
from ..data.transforms import augment
from ..utils.meters import AverageMeter
from ..utils.profiling import span
from .train_step import to_device


class Trainer:
    def __init__(self, train_step, scalar_writer=None, print_freq=100, seed=0, stop_event=None,
                 device=None, mesh=None):
        self.train_step = train_step
        self.writer = scalar_writer
        self.print_freq = print_freq
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else mesh.device
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.stop_event = stop_event

    # how often (in steps) the group's stop check runs: a host-side
    # all-reduce every step would cost more than it buys, and ten steps
    # stay well inside a SIGTERM grace window
    STOP_SYNC_EVERY = 10

    def _stop_requested(self, step_index):
        """The stop check at a step boundary. Under a group it is collective
        and runs at the same step indices on every rank (every
        ``STOP_SYNC_EVERY`` steps, and once at the end of every epoch in
        ``train``): every rank contributes its local flag, and all stop if
        any saw a signal."""
        local = self.stop_event is not None and self.stop_event.is_set()
        if self.mesh is None:
            return local
        if step_index % self.STOP_SYNC_EVERY:
            return False
        return self._collective_stop()

    def _collective_stop(self):
        """All-reduce the local stop flags on the host; any rank's stops
        every rank, and sets every rank's ``stop_event``, so the caller's
        checkpoint gate after the epoch fires on ranks that never got the
        signal. Every rank must call it the same number of times."""
        local = self.stop_event is not None and self.stop_event.is_set()
        stop = self.mesh.any_host(local)
        if stop and self.stop_event is not None:
            self.stop_event.set()
        return stop

    def train(self, epoch, train_state, loader, lr):
        batch_time = AverageMeter()
        data_time = AverageMeter()
        losses = AverageMeter()
        prec_uncorr = AverageMeter()
        prec_vid = AverageMeter()
        prec_frame = AverageMeter()

        num_steps = len(loader)
        end = time.time()

        def materialize(pending):
            """Read a queued step's metrics (waits for that step only) and print them."""
            m, n, i = pending
            losses.update(float(m["loss"]), n)
            prec_uncorr.update(float(m["prec_uncorr"]), n)
            prec_vid.update(float(m["prec_vid"]), n)
            prec_frame.update(float(m["prec_frame"]), n)
            if self.writer is not None:
                step = num_steps * epoch + i
                self.writer.add_scalar("train/total_loss_step", losses.val, step)
                self.writer.add_scalar("train/total_loss_avg", losses.avg, step)
            if (i + 1) % self.print_freq == 0:
                print(
                    "Epoch: [{}][{}/{}]\t"
                    "Loss {:.3f} ({:.3f})\t"
                    "uncorr_vid {:.2%} ({:.2%})\t"
                    "corr_vid {:.2%} ({:.2%})\t"
                    "corr_frame {:.2%} ({:.2%})\t".format(
                        epoch, i + 1, num_steps,
                        losses.val, losses.avg,
                        prec_uncorr.val, prec_uncorr.avg,
                        prec_vid.val, prec_vid.avg,
                        prec_frame.val, prec_frame.avg,
                    )
                )

        ranks = 1 if self.mesh is None else self.mesh.size
        pending = None
        it = iter(loader)
        for i in itertools.count():
            with span("trainer.iteration"):
                with span("trainer.data_wait"):
                    batch = next(it, None)
                if batch is None:
                    break
                clips_u8, pids, _camids = batch
                if self._stop_requested(i):
                    print(f"Epoch: [{epoch}][{i}/{num_steps}]\tstop requested; ending epoch early")
                    break
                data_time.update(time.time() - end)

                b = clips_u8.shape[0]
                rows = None if self.mesh is None else (self.mesh.rank * b, ranks * b)
                with span("trainer.upload"):
                    clips_u8 = to_device(clips_u8, self.device)
                with span("trainer.augment"):
                    clips = augment(self.gen, clips_u8, train=True, rows=rows)
                with span("trainer.step"):
                    train_state, m = self.train_step(train_state, clips, pids, lr)

                if pending is not None:
                    with span("trainer.read"):
                        materialize(pending)
                pending = (m, b * ranks, i)

                batch_time.update(time.time() - end)
                end = time.time()
        if pending is not None:
            with span("trainer.read"):
                materialize(pending)
        if self.mesh is not None:
            # once per epoch on every rank: a signal after the last periodic
            # check, or on one rank only, still reaches every stop_event
            self._collective_stop()
        if self.writer is not None:
            self.writer.flush()
        return train_state, {
            "loss": losses.avg,
            "prec_uncorr": prec_uncorr.avg,
            "prec_vid": prec_vid.avg,
            "prec_frame": prec_frame.avg,
            "batch_time": batch_time.avg,
            "data_time": data_time.avg,
        }
