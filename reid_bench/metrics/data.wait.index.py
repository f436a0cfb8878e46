"""The share of the index window the host spent waiting in the loader's
``next()`` inside ``extract_features`` (the harness's ``loader.next``
spans)."""


def read(run):
    if "loader_wait_s" not in run.counters:
        return None
    return 100.0 * run.counters["loader_wait_s"] / run.window_s
