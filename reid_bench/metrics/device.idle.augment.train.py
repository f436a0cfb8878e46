"""The share of the traced training window in which the card was idle
while the trainer enqueued a step's augmentation: the device idle time
under the program's ``trainer.augment`` spans over the window."""

from reid_bench.program_spans import idle_share


def read(run):
    return idle_share(run, "trainer.iteration", "trainer.augment")
