"""The share of the training window the trainer spent waiting for its
loader: ``Trainer.train``'s ``data_time`` of every step over the window."""


def read(run):
    if "data_wait_s" not in run.counters:
        return None
    return 100.0 * run.counters["data_wait_s"] / run.window_s
