"""The share of the traced training window in which the card was idle
while the host enqueued the training step (forward, backward, SGD, the
OIM tables): the device idle time under the program's ``trainer.step``
spans over the window."""

from reid_bench.program_spans import idle_share


def read(run):
    return idle_share(run, "trainer.iteration", "trainer.step")
