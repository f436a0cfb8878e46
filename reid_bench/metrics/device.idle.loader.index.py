"""The share of the traced index window in which the card was idle while
the evaluator waited for its loader: the device idle time under the
program's ``evaluator.loader_wait`` spans (the innermost open) over the
window."""

from reid_bench.program_spans import idle_share


def read(run):
    return idle_share(run, "evaluator.extract_features", "evaluator.loader_wait")
