"""The share of the traced index window in which the card was idle while
the evaluator concatenated pending clips into a micro-batch: the device
idle time under the program's ``evaluator.pack`` spans over the window."""

from reid_bench.program_spans import idle_share


def read(run):
    return idle_share(run, "evaluator.extract_features", "evaluator.pack")
