"""The serve daemon's parts on their own, in this process on the CPU, with
no artifact and no model: the gallery index (``cli.extract._GalleryIndex``)
and the transport (``cli.transport.Transport``) with a stub ``handle``.

The whole daemon against grl_tpu's is ``tests/test_torch_extract.py``.
"""

import io
import json
import os.path as osp
import socket
import sys
import threading
import time

import numpy as np
import pytest
import torch

from grl_tpu_torch.cli import extract as T
from grl_tpu_torch.cli.transport import Transport
from grl_tpu_torch.engine.evaluator import rerank_inputs
from grl_tpu_torch.engine.rerank import re_ranking_host

DIM = 16


def _unit(rng, n):
    f = rng.randn(n, DIM).astype(np.float32)
    return f / np.linalg.norm(f, axis=1, keepdims=True)


def _index(feats, capacity, q_pad=4, topk=10, staged=False):
    n = feats.shape[0]
    return T._GalleryIndex(feats, np.arange(n, dtype=np.int64), np.zeros(n, np.int64), capacity, q_pad, topk,
                           torch.device("cpu"), staged=staged)


def test_enrolling_past_capacity_raises_and_keeps_the_count():
    rng = np.random.RandomState(0)
    index = _index(_unit(rng, 10), capacity=12)
    with pytest.raises(ValueError, match="exceeds capacity"):
        index.enroll(_unit(rng, 3), np.zeros(3, np.int64), np.zeros(3, np.int64))
    assert index.n == 10 and index.pids.shape == (10,)
    assert index.enroll(_unit(rng, 2), np.full(2, 7), np.full(2, 1)) == 12
    payload, n = index.save()
    assert n == 12 and payload["features"].shape == (12, DIM) and list(payload["pids"][-2:]) == [7, 7]


def test_concurrent_enrollment_loses_no_row():
    """16 threads enroll 5 blocks of 3 rows each at a short switch interval:
    the lock keeps every row and its label together, none lost or
    overwritten."""
    index = _index(np.zeros((0, DIM), np.float32), capacity=240)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def enroll(t):
        for b in range(5):
            tag = 100 * t + b
            index.enroll(np.full((3, DIM), tag, np.float32), np.full(3, tag), np.zeros(3, np.int64))

    try:
        threads = [threading.Thread(target=enroll, args=(t,)) for t in range(16)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=30)
    finally:
        sys.setswitchinterval(switch)
    assert not any(thread.is_alive() for thread in threads)
    payload, n = index.save()
    assert n == 240
    np.testing.assert_array_equal(payload["features"][:, 0], payload["pids"])  # each row beside its own label
    assert sorted(payload["pids"]) == sorted(np.repeat([100 * t + b for t in range(16) for b in range(5)], 3))


def test_a_plain_rank_never_returns_a_padding_row():
    """Every query's similarity to every valid row is negative, so an
    unmasked zero row (similarity 0) would come first."""
    rng = np.random.RandomState(1)
    gallery, queries = rng.randn(6, DIM).astype(np.float32), 0.1 * rng.randn(3, DIM).astype(np.float32)
    gallery[:, 0], queries[:, 0] = 3 + np.abs(gallery[:, 0]), -1  # opposite halves of the sphere
    gallery /= np.linalg.norm(gallery, axis=1, keepdims=True)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    assert (queries @ gallery.T < 0).all()
    index = _index(gallery, capacity=40)
    results = index.rank(queries, 10)["results"]
    assert len(results) == 3
    for rec in results:
        got = [m["gallery"] for m in rec["matches"]]
        assert sorted(got) == list(range(6))  # topk cut to the valid count, no row past it
        scores = [m["score"] for m in rec["matches"]]
        assert scores == sorted(scores, reverse=True) and max(scores) < 0


@pytest.mark.parametrize("route", ["padded", "staged"])
def test_a_reranked_rank_orders_as_the_host_form(route, monkeypatch):
    """Both routes of the index, the staged one with re-ranking's cut
    shrunk, give ``re_ranking_host``'s order over the valid rows, at toy n
    on features without ties."""
    if route == "staged":
        monkeypatch.setattr(T.rerank, "ONE_PROGRAM_MAX", 8)
    rng = np.random.RandomState(2)
    gallery, queries = _unit(rng, 44), _unit(rng, 3)
    index = _index(gallery[:40], capacity=48)
    index.enroll(gallery[40:], np.arange(40, 44), np.zeros(4, np.int64))
    assert index.staged == (route == "staged")
    resp = index.rank_reranked(queries, 5)
    host = re_ranking_host(*(m.numpy() for m in rerank_inputs(torch.from_numpy(queries), torch.from_numpy(gallery))))
    assert resp["reranked"] and "warning" not in resp and len(resp["results"]) == 3
    for qi, rec in enumerate(resp["results"]):
        got = [m["gallery"] for m in rec["matches"]]
        np.testing.assert_array_equal(got, np.argsort(host[qi], kind="stable")[:5])
        np.testing.assert_allclose([m["score"] for m in rec["matches"]], -host[qi][got], rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="query width is 4"):
        index.rank_reranked(_unit(rng, 5), 5)


def _echo(req):
    if req.get("op") == "boom":
        raise RuntimeError("boom")
    return {"ok": True, "op": req.get("op")}


def test_an_oversize_line_is_drained_and_the_conversation_goes_on():
    """A line over the cap gets an error and is read to its end; the next
    requests are answered; a shutdown op ends the loop before the line
    after it; the stats count every op."""
    lines = [json.dumps({"op": "ping"}), json.dumps({"op": "ping", "pad": "x" * 3000}), "not json",
             json.dumps({"op": "boom"}), json.dumps({"op": "ping"}), json.dumps({"op": "shutdown"}),
             json.dumps({"op": "ping"})]
    transport, out = Transport(max_request_mb=1e-3), io.StringIO()
    served = transport.run(_echo, io.StringIO("".join(line + "\n" for line in lines)), out)
    resps = [json.loads(line) for line in out.getvalue().splitlines()]
    assert served == 5 and len(resps) == 6  # the oversize answer is not counted as served
    assert resps[0]["ok"] and resps[0]["op"] == "ping" and isinstance(resps[0]["ms"], float)
    assert not resps[1]["ok"] and "--max-request-mb" in resps[1]["error"] and resps[1]["ms"] == 0.0
    assert not resps[2]["ok"] and resps[2]["error"].startswith("JSONDecodeError") and "op" not in resps[2]
    assert resps[3] == {"ok": False, "error": "RuntimeError: boom", "op": "boom", "ms": resps[3]["ms"]}
    assert resps[4]["ok"] and resps[5] == {"ok": True, "op": "shutdown", "ms": resps[5]["ms"]}
    ops = transport.stats()["ops"]
    assert {k: (v["n"], v["errors"]) for k, v in ops.items()} == {
        "ping": (2, 0), "oversize": (1, 1), "invalid": (1, 1), "boom": (1, 1), "shutdown": (1, 0)}


def _connect(path):
    """A client of the unix socket at ``path``, once it listens."""
    for _ in range(1000):
        client = socket.socket(socket.AF_UNIX)
        try:
            client.connect(path)
            return client
        except (FileNotFoundError, ConnectionRefusedError):
            client.close()
            time.sleep(0.01)
    raise TimeoutError(f"nothing listens on {path}")


def test_a_shutdown_op_stops_the_socket_loop(tmp_path):
    """On a unix socket: two clients at once, the first idle, the second's
    shutdown op stops the accept loop; the socket file is removed."""
    path = str(tmp_path / "t.sock")
    transport = Transport(listen=f"unix:{path}")
    result = []
    thread = threading.Thread(target=lambda: result.append(transport.run(_echo, None, None)), daemon=True)
    thread.start()
    idle, active = _connect(path), _connect(path)
    with active.makefile("rw", encoding="utf-8") as f:
        for op in ("ping", "shutdown"):
            f.write(json.dumps({"op": op}) + "\n")
            f.flush()
            assert json.loads(f.readline())["op"] == op
    thread.join(timeout=10)
    idle.close()
    active.close()
    assert not thread.is_alive() and result == [2] and transport.stopping and not osp.exists(path)
