"""The port's spans (``grl_tpu_torch/utils/profiling.py``) on the CPU.

Off, ``span`` is one shared no-op that reads no clock; under a
``torch.profiler`` session it records names, parents, requests and threads
on the profiler's clock, in a bounded buffer that also takes spans from
another process. The dense evaluator, ``Trainer.train`` and the serve
daemon's re-ranked ``rank`` record their layer spans, and give the same
answers and the same response keys as without a profiler; ``ServeClient``
takes a traced response's spans off it and records them.
"""

import collections
import io
import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from grl_tpu_torch import models as tm
from grl_tpu_torch.cli import extract as T
from grl_tpu_torch.client import ServeClient
from grl_tpu_torch.data import ClipDataset, ClipLoader
from grl_tpu_torch.engine import Evaluator, Trainer
from grl_tpu_torch.utils import profiling

DIM = 24
RERANK_STAGES = {"rerank.distances", "rerank.original", "rerank.nearest", "rerank.expand", "rerank.query_expand",
                 "rerank.min_sum", "rerank.blend"}


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.clear()
    yield
    profiling.clear()


def traced():
    return profile(activities=[ProfilerActivity.CPU])


def by_name(spans):
    out = collections.defaultdict(list)
    for sp in spans:
        out[sp.name].append(sp)
    return out


def test_off_a_span_is_one_shared_no_op_that_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("the clock was read")

    monkeypatch.setattr(time, "time_ns", no_clock)
    first = profiling.span("a")
    assert profiling.span("b", device="cpu") is first
    with first as entered, profiling.span("c"):
        assert entered.descendants() == []
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_names_parents_requests_and_threads_are_recorded():
    def worker():
        with profiling.span("other.root"), profiling.span("other.child"):
            pass

    with traced():
        with profiling.span("root") as root:
            with profiling.span("child"), profiling.span("grandchild"):
                pass
            thread = threading.Thread(target=worker)
            thread.start()
            thread.join()
    got = by_name(profiling.spans())
    (r,), (c,), (g,) = got["root"], got["child"], got["grandchild"]
    assert r.parent_id is None and c.parent_id == r.span_id and g.parent_id == c.span_id
    assert r.request_id == c.request_id == g.request_id == r.span_id
    assert r.start_ns <= c.start_ns <= g.start_ns <= g.end_ns <= c.end_ns <= r.end_ns
    assert {sp.thread_id for sp in (r, c, g)} == {threading.get_ident()}
    assert [sp.name for sp in root.descendants()] == ["grandchild", "child"]
    (o,), (oc,) = got["other.root"], got["other.child"]
    assert o.parent_id is None and oc.parent_id == o.span_id and oc.request_id == o.span_id
    assert o.thread_id == oc.thread_id != r.thread_id
    assert all(sp.device_ms is None for sp in profiling.spans())
    assert len({sp.span_id for sp in profiling.spans()}) == 5


def test_a_span_encloses_its_operator_on_the_profiler_s_clock():
    a, b = torch.randn(256, 256), torch.randn(256, 256)
    with traced() as prof:
        time.sleep(0.002)
        with profiling.span("matmul"):
            a @ b
        time.sleep(0.002)
    (sp,) = profiling.spans()
    ops = [ev for ev in prof.profiler.kineto_results.events() if ev.name() == "aten::mm"]
    assert len(ops) == 1
    assert sp.start_ns <= ops[0].start_ns() <= ops[0].end_ns() <= sp.end_ns


def test_the_buffer_drops_its_oldest_spans_and_counts_them(monkeypatch):
    monkeypatch.setattr(profiling, "_buffer", collections.deque(maxlen=3))
    with traced():
        for i in range(5):
            with profiling.span(f"s{i}"):
                pass
    assert [sp.name for sp in profiling.spans()] == ["s2", "s3", "s4"] and profiling.dropped() == 2
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_spans_of_another_process_are_recorded_as_given():
    foreign = [["serve.lock_wait", 10, 20, 2, 1, 1, 5, None], ["rerank.min_sum", 21, 30, 3, 1, 1, 5, 0.25]]
    profiling.record(foreign)
    got = profiling.spans()
    assert [list(sp) for sp in got] == foreign and got[1].device_ms == 0.25


def _tiny_evaluator(micro_batch):
    torch.manual_seed(0)
    cnn = tm.GRLModel(trunk=tm.ResNetTrunk(layers=(1, 1, 1, 1), last_stride=1, width=2))
    siamese = tm.Siamese(input_num=cnn.num_feat, output_num=8)
    return Evaluator(cnn, siamese, micro_batch=micro_batch, device="cpu")


def test_the_dense_path_spans_each_micro_batch_and_answers_alike():
    rng = np.random.RandomState(0)
    lengths = (5, 9, 2, 7, 4)  # 2-frame clips: 3 + 5 + 1 + 4 + 2 = 15, micro-batches of 4: 4 of them
    items = [(rng.randint(0, 256, (n, 32, 16, 3), np.uint8), i, i % 2) for i, n in enumerate(lengths)]
    ev = _tiny_evaluator(4)

    def extract():
        return ev.extract_features(ClipLoader(ClipDataset(items, 2, "dense", 32, 16), batch_size=1, workers=1))

    plain, pids, _ = extract()
    assert profiling.spans() == []
    with traced():
        feats, traced_pids, _ = extract()
    assert torch.equal(feats, plain) and list(pids) == list(traced_pids)
    got = by_name(profiling.spans())
    (root,) = got["evaluator.extract_features"]
    assert len(got["evaluator.describe"]) == len(got["evaluator.upload"]) == 4
    assert len(got["evaluator.accumulate"]) == len(got["evaluator.pack"]) == 4
    assert len(got["evaluator.loader_wait"]) == len(lengths) + 1 and len(got["evaluator.pool"]) == 1
    assert all(sp.parent_id == root.span_id for name, s in got.items() if name != root.name for sp in s)


class _Writer:
    def add_scalar(self, *a):
        pass

    def flush(self):
        pass


def test_a_training_loop_spans_each_step_and_returns_the_same_stats():
    def step(state, clips, pids, lr):
        m = {k: clips.float().mean() for k in ("loss", "prec_uncorr", "prec_vid", "prec_frame")}
        return state + 1, m

    rng = np.random.RandomState(1)
    batches = [(rng.randint(0, 256, (2, 2, 16, 8, 3), np.uint8), np.array([0, 0]), np.array([0, 1]))
               for _ in range(3)]
    trainer = Trainer(step, scalar_writer=_Writer(), print_freq=10**9, device="cpu")
    state, plain = trainer.train(0, 0, batches, 0.1)
    assert state == 3 and profiling.spans() == []
    with traced():
        state, stats = Trainer(step, scalar_writer=_Writer(), print_freq=10**9, device="cpu").train(
            0, 0, batches, 0.1)
    assert state == 3 and list(stats) == list(plain) and stats["loss"] == plain["loss"]
    got = by_name(profiling.spans())
    for name in ("trainer.upload", "trainer.augment", "trainer.step", "trainer.read"):
        assert len(got[name]) == 3, name
    # one more pass of the loop finds the loader spent
    assert len(got["trainer.iteration"]) == len(got["trainer.data_wait"]) == 4
    roots = {sp.span_id for sp in got["trainer.iteration"]}
    last_read = max(got["trainer.read"], key=lambda sp: sp.start_ns)
    assert last_read.parent_id is None
    assert all(sp.parent_id in roots for name in ("trainer.data_wait", "trainer.upload", "trainer.augment",
                                                  "trainer.step") for sp in got[name])


@pytest.fixture(scope="module")
def daemon(tmp_path_factory):
    """The serve daemon's arguments over a stand-in artifact (a ``rank`` with
    features describes no clip), and an enrollment and a query script."""
    tmp = tmp_path_factory.mktemp("tracing")
    rng = np.random.RandomState(2)
    feats = rng.randn(44, DIM).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    np.savez(tmp / "gallery.npz", features=feats[:40], pids=np.arange(40), camids=np.arange(40) % 2)
    np.savez(tmp / "queries.npz", features=feats[40:])
    meta = {"batch": 4, "dim": DIM, "seq_len": 2, "height": 32, "width": 16, "channels": 3}
    argv = ["--device", "cpu", "serve", "--model", "unused.npz", "--gallery", str(tmp / "gallery.npz"),
            "--capacity", "48", "--topk", "3", "--rerank-queries", "4"]
    reqs = [{"op": "rank", "features": str(tmp / "queries.npz"), "rerank": True},
            {"op": "rank", "features": str(tmp / "queries.npz")}]
    return argv, meta, reqs


def _serve(argv, meta, reqs, monkeypatch):
    monkeypatch.setattr(T, "_load_artifact", lambda path, device: (None, meta))
    out = io.StringIO()
    T.serve(T.build_parser().parse_args(argv), inp=io.StringIO("".join(json.dumps(r) + "\n" for r in reqs)),
            out=out)
    return out.getvalue().splitlines()


def test_a_traced_rerank_response_carries_its_spans_and_an_untraced_one_does_not(daemon, monkeypatch):
    argv, meta, reqs = daemon
    plain_rr, plain_rank = (json.loads(line) for line in _serve(argv, meta, reqs, monkeypatch))
    assert set(plain_rr) == {"ok", "op", "reranked", "results", "ms"}
    assert set(plain_rank) == {"ok", "op", "results", "ms"}
    with traced():
        lines = _serve(argv, meta, reqs, monkeypatch)
    rr, rank = (json.loads(line) for line in lines)
    assert rr.pop("spans") and rank.pop("spans")
    assert set(rr) == set(plain_rr) and set(rank) == set(plain_rank)
    assert rr["results"] == plain_rr["results"] and rank["results"] == plain_rank["results"]

    names = collections.Counter(sp[0] for sp in json.loads(lines[0])["spans"])
    assert RERANK_STAGES | {"serve.decode", "serve.lock_wait", "serve.lock_held", "serve.read",
                            "serve.respond"} == set(names)
    assert all(n == 1 for n in names.values())
    spans = {sp[0]: profiling.Span(*sp) for sp in json.loads(lines[0])["spans"]}
    held = spans["serve.lock_held"]
    assert spans["serve.lock_wait"].end_ns <= held.start_ns and len({sp.request_id for sp in spans.values()}) == 1
    assert all(held.start_ns <= spans[n].start_ns <= spans[n].end_ns <= held.end_ns
               for n in RERANK_STAGES | {"serve.read", "serve.respond"})
    assert all(sp.device_ms is None for sp in spans.values())  # on the CPU

    # the client takes them off the response and records them here
    profiling.clear()
    client = ServeClient(io.StringIO(lines[0] + "\n"), io.StringIO())
    resp = client.request("rank", features="unused.npz", rerank=True)
    assert set(resp) == set(plain_rr)
    assert collections.Counter(sp.name for sp in profiling.spans()) == names
