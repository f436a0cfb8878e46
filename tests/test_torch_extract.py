"""The port's serving entry point (``grl_tpu_torch/cli/extract.py``) and
client on the CPU (``--device cpu``), against grl_tpu's.

One ``--tiny`` checkpoint, written by grl_tpu's ``save_train_state``,
serves both packages: their ``features`` and ``rank`` agree (features
within 1e-4, the same ranked orders), each package's ``export-model``
artifact describes as its own modules do, grl_tpu's ``jax.export``
artifact is refused by the port, and the same request script sent to
both daemons gives the same response keys, the same matches and scores
within 1e-4. Either package's ``ServeClient`` drives the port's daemon.
"""

import argparse
import io
import json
import os
import os.path as osp
import signal
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from grl_tpu.cli import extract as J
from grl_tpu_torch.cli import extract as T

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
TINY = ["-d", "synthetic", "--tiny", "--seq_len", "2", "-j", "2"]
EXPORT = ["--tiny", "--num-classes", "4", "--batch", "4", "--seq_len", "2", "--height", "64", "--width", "32"]
DIM = 384  # 3 x the tiny trunk's 128 features
ATOL = 1e-4


def port_main(*argv):
    return T.main(T.build_parser().parse_args(["--device", "cpu", *argv]))


def jax_main(*argv):
    return J.main(J.build_parser().parse_args(list(argv)))


def port_serve(argv, requests, **kw):
    """The port's daemon over stdin/stdout (StringIO); the parsed responses."""
    out = io.StringIO()
    T.serve(T.build_parser().parse_args(["--device", "cpu", "serve", *argv]),
            inp=io.StringIO("".join((r if isinstance(r, str) else json.dumps(r)) + "\n" for r in requests)),
            out=out, **kw)
    return [json.loads(line) for line in out.getvalue().splitlines()]


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    """A grl_tpu checkpoint (tiny, random init, 4 classes), each package's
    artifact exported from it, clips, and a gallery of unit features."""
    import jax

    from grl_tpu.cli.train import build_models
    from grl_tpu.engine.optim import SGD
    from grl_tpu.engine.train_step import init_train_state
    from grl_tpu.utils.serialization import save_train_state

    tmp = tmp_path_factory.mktemp("extract")
    ckpts = {}
    for flow in (False, True):
        cnn, sia, unc = build_models(SimpleNamespace(bf16=False, use_flow=flow, arch2="siamese"), tiny=True)
        state = init_train_state(jax.random.PRNGKey(0), cnn, sia, unc, 4, cnn.num_feat, SGD())
        ckpts[flow] = str(tmp / f"checkpoint{'_flow' if flow else ''}.npz")
        save_train_state(state, {"epoch": 1, "best_top1": 0.0}, ckpts[flow])
    ckpt = ckpts[False]
    port_main("export-model", "--checkpoint", ckpt, *EXPORT, "-o", str(tmp / "port.npz"))
    jax_main("export-model", "--checkpoint", ckpt, *EXPORT, "-o", str(tmp / "jax.npz"))
    rng = np.random.RandomState(0)
    clips = rng.randint(0, 256, (6, 2, 64, 32, 3), np.uint8)
    np.savez(tmp / "clips.npz", clips=clips, pids=np.arange(6))
    feats = rng.randn(348, DIM).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    np.savez(tmp / "gallery.npz", features=feats[:40], pids=np.arange(40), camids=np.arange(40) % 2)
    np.savez(tmp / "more.npz", features=feats[40:339], pids=np.arange(40, 339), camids=np.arange(299) % 6)
    np.savez(tmp / "queries.npz", features=feats[339:343])
    np.savez(tmp / "queries5.npz", features=feats[343:348])
    return SimpleNamespace(dir=tmp, ckpt=ckpt, flow_ckpt=ckpts[True], port=str(tmp / "port.npz"),
                           jax=str(tmp / "jax.npz"), clips=clips,
                           feats=feats, path=lambda name: str(tmp / name))


@pytest.fixture(scope="module")
def features(art):
    """``features`` of query and gallery from both packages."""
    out = {}
    for pkg, run in (("port", port_main), ("jax", jax_main)):
        for split in ("query", "gallery"):
            path = art.path(f"{pkg}_{split}.npz")
            run("features", *TINY, "--checkpoint", art.ckpt, "--split", split, "-o", path)
            out[pkg, split] = path
    return out


def test_features_match_grl_tpu(features):
    for split in ("query", "gallery"):
        got, want = np.load(features["port", split]), np.load(features["jax", split])
        assert sorted(got.files) == sorted(want.files) == ["camids", "features", "pids"]
        np.testing.assert_array_equal(got["pids"], want["pids"])
        np.testing.assert_array_equal(got["camids"], want["camids"])
        np.testing.assert_allclose(got["features"], want["features"], rtol=0, atol=ATOL)


@pytest.mark.parametrize("rerank", [False, True], ids=["plain", "rerank"])
def test_rank_orders_match_grl_tpu(art, features, rerank):
    """The same ranked orders from both packages' ``rank`` on the same
    features (grl_tpu's re-ranking on the CPU is its host form, the
    port's the device builders with the plain min-sum)."""
    flags = ["--rerank"] if rerank else []
    results = {}
    for pkg, run in (("port", port_main), ("jax", jax_main)):
        results[pkg] = run("rank", "--query", features["jax", "query"], "--gallery", features["jax", "gallery"],
                           "--topk", "5", *flags, "-o", art.path(f"{pkg}_ranks.json"))
    assert json.load(open(art.path("port_ranks.json"))) == results["port"]
    for got, want in zip(results["port"], results["jax"]):
        assert got["query"] == want["query"] and got["query_pid"] == want["query_pid"]
        assert [m["gallery"] for m in got["matches"]] == [m["gallery"] for m in want["matches"]]
        assert [m["pid"] for m in got["matches"]] == [m["pid"] for m in want["matches"]]
        np.testing.assert_allclose([m["score"] for m in got["matches"]], [m["score"] for m in want["matches"]],
                                   rtol=0, atol=ATOL)


def test_export_describe_matches_the_modules_and_grl_tpu(art):
    """``describe`` through the port's artifact (six clips, batch 4: the
    last chunk padded) equals the port's descriptor on the checkpoint's
    modules, and grl_tpu's artifact within 1e-4."""
    from grl_tpu_torch.engine import init_train_state, make_descriptor_fn
    from grl_tpu_torch.utils import load_train_state

    port_main("describe", "--model", art.port, "--clips", art.path("clips.npz"), "-o", art.path("port_f.npz"))
    jax_main("describe", "--model", art.jax, "--clips", art.path("clips.npz"), "-o", art.path("jax_f.npz"))
    got = np.load(art.path("port_f.npz"))
    assert list(got["pids"]) == list(range(6))  # passthrough
    meta = json.loads(str(np.load(art.port)["meta"]))
    assert meta == {"batch": 4, "seq_len": 2, "height": 64, "width": 32, "channels": 3, "platforms": ["cpu"],
                    "dim": DIM}
    cnn, sia, unc = T.build_models(SimpleNamespace(arch2="siamese", seed=0), tiny=True)
    state = init_train_state(cnn, sia, unc, 4, num_feat=cnn.num_feat, device="cpu")
    load_train_state(state, art.ckpt)
    with torch.inference_mode():
        want = make_descriptor_fn(cnn.eval(), sia.eval())(torch.from_numpy(art.clips)).numpy()
    np.testing.assert_allclose(got["features"], want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["features"], np.load(art.path("jax_f.npz"))["features"], rtol=0, atol=ATOL)


def test_artifacts_of_the_other_package_or_device_are_refused(art, tmp_path):
    with pytest.raises(SystemExit, match="grl_tpu.cli.extract"):
        port_main("describe", "--model", art.jax, "--clips", art.path("clips.npz"), "-o", str(tmp_path / "f.npz"))
    with np.load(art.port) as z:
        meta = json.loads(str(z["meta"]))
        np.savez(tmp_path / "cuda.npz", exported=z["exported"], meta=json.dumps({**meta, "platforms": ["cuda"]}))
    with pytest.raises(SystemExit, match="--device cpu"):
        T._load_artifact(str(tmp_path / "cuda.npz"), "cpu")


@pytest.mark.parametrize("case", ["test_uncontended_matches_sequential_chunking",
                                  "test_concurrent_waiters_pack_one_dispatch",
                                  "test_packing_respects_batch_width",
                                  "test_dispatch_error_reaches_every_waiter"])
def test_coalescer_cases_of_grl_tpu_hold_for_the_port(case, monkeypatch):
    """grl_tpu's four coalescer tests, run on the port's ``_DescribeCoalescer``
    and ``_describe_chunked``."""
    import test_serve_coalescer as C

    monkeypatch.setattr(C, "_DescribeCoalescer", T._DescribeCoalescer)
    monkeypatch.setattr(C, "_describe_chunked", T._describe_chunked)
    getattr(C, case)()


def _export_keeping_the_example(art, out):
    """``export-model`` as it was before it cleared the example input: the
    same checkpoint, flags and export, saved with the zero example batch."""
    args = T.build_parser().parse_args(["--device", "cpu", "export-model", "--checkpoint", art.ckpt, *EXPORT,
                                        "-o", out])
    cnn, siamese = T._load_models(args, args.num_classes, torch.device("cpu"))
    example = torch.zeros((args.batch, args.seq_len, args.height, args.width, 3), dtype=torch.uint8)
    program = torch.export.export(T._DescriptorProgram(cnn, siamese).eval(), (example,))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    with np.load(art.port) as z:
        meta = str(z["meta"])
    np.savez(out, exported=np.frombuffer(buf.getvalue(), np.uint8), meta=meta)
    return example.numel()


def test_artifact_drops_its_example_input_and_answers_bit_equal(art):
    """The artifact no longer carries the zero example batch: its program is
    smaller than the one saved with it by the batch's bytes (and a little
    of its record), loads with no example inputs, keeps the shapes in its
    meta, and answers bit-equal to it through ``describe`` and the daemon."""
    old = art.path("port_with_example.npz")
    example_bytes = _export_keeping_the_example(art, old)
    assert example_bytes == 4 * 2 * 64 * 32 * 3
    blobs = {}
    for name, path in (("old", old), ("new", art.port)):
        with np.load(path) as z:
            blobs[name] = z["exported"].tobytes()
            assert json.loads(str(z["meta"]))["batch"] == 4  # the shapes stay in the meta
    dropped = len(blobs["old"]) - len(blobs["new"])
    assert example_bytes <= dropped <= example_bytes + 16384, (dropped, example_bytes)
    assert torch.export.load(io.BytesIO(blobs["new"])).example_inputs is None
    assert torch.export.load(io.BytesIO(blobs["old"])).example_inputs[0][0].shape == (4, 2, 64, 32, 3)

    feats = {}
    for name, path in (("old", old), ("new", art.port)):
        out = art.path(f"c3_{name}.npz")
        port_main("describe", "--model", path, "--clips", art.path("clips.npz"), "-o", out)
        (desc,) = [r for r in port_serve(["--model", path], [{"op": "describe", "clips": art.path("clips.npz"),
                                                              "out": art.path(f"c3_{name}_d.npz")}])
                   if r["op"] == "describe"]
        assert desc["ok"] and desc["n"] == 6
        feats[name] = np.load(out)["features"], np.load(art.path(f"c3_{name}_d.npz"))["features"]
    for got, want in zip(feats["new"], feats["old"]):
        assert got.dtype == want.dtype == np.float32 and got.tobytes() == want.tobytes()


def _clip_call(calls, lock, seconds=0.0):
    """A fake artifact call: records each dispatched chunk and 'describes'
    a (k, 1, 1, 1, 3) clip as its pixel values x 2 (routing mistakes show)."""
    import time

    def call(chunk):
        with lock:
            calls.append(np.array(chunk))
        time.sleep(seconds)
        return chunk.reshape(chunk.shape[0], -1).astype(np.float32) * 2

    return call


def _clip(v):
    return np.full((1, 1, 1, 1, 3), v, np.uint8)


@pytest.mark.parametrize("batch", [4, 8])
def test_coalescer_packs_six_threads_as_grl_tpu_s(batch):
    """Six threads' one-clip requests queued while the device is busy:
    the port's coalescer and grl_tpu's dispatch the same FIFO packs with
    the same counters, every thread gets its own rows; then six threads x
    eight requests free-running: every answer its own, the counters
    consistent with the dispatches made."""
    import threading
    import time

    packs = {}
    for name, cls in (("port", T._DescribeCoalescer), ("jax", J._DescribeCoalescer)):
        calls, lock, out = [], threading.Lock(), {}
        co = cls(_clip_call(calls, lock), batch=batch)
        co._device.acquire()
        try:
            threads = [threading.Thread(target=lambda v=v: out.update({v: co.describe(_clip(v))}))
                       for v in range(1, 7)]
            for i, t in enumerate(threads):
                t.start()
                deadline = time.time() + 10
                while True:  # queue in thread order, so FIFO is the threads' order
                    with co._qlock:
                        if len(co._q) == i + 1:
                            break
                    assert time.time() < deadline, "waiter never queued"
                    time.sleep(0.002)
        finally:
            co._device.release()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        for v in range(1, 7):
            np.testing.assert_array_equal(out[v], np.full((1, 3), 2.0 * v))
        packs[name] = [[int(c[i, 0, 0, 0, 0]) for i in range(c.shape[0])] for c in calls], co.snapshot()
    assert packs["port"] == packs["jax"]
    assert packs["port"][0][0][:min(batch, 6)] == list(range(1, min(batch, 6) + 1))

    calls, lock = [], threading.Lock()
    co = T._DescribeCoalescer(_clip_call(calls, lock, seconds=0.002), batch=batch)
    errors = []

    def client(i):
        for j in range(8):
            v = 1 + i * 8 + j
            got = co.describe(_clip(v))
            if not np.array_equal(got, np.full((1, 3), 2.0 * v)):
                errors.append((v, got))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors
    snap = co.snapshot()
    assert snap["clips"] == 48 and snap["dispatches"] == len(calls)
    assert all(c.shape[0] == batch for c in calls)
    assert snap["packed"] == sum(int(np.count_nonzero(c[:, 0, 0, 0, 0])) > 1 for c in calls)
    assert sorted(int(v) for c in calls for v in c[:, 0, 0, 0, 0] if v) == list(range(1, 49))


def test_coalescer_lone_request_is_the_sequential_path_bit_for_bit():
    """One request alone: the same padded chunks and the same bytes as
    ``_describe_chunked``, for sizes around the batch width."""
    import threading

    rng = np.random.RandomState(0)
    lock = threading.Lock()
    for n in (1, 3, 4, 5, 9):
        clips = rng.randint(0, 256, (n, 1, 1, 1, 3), np.uint8)
        calls, seq = [], []
        co = T._DescribeCoalescer(_clip_call(calls, lock), batch=4)
        got = co.describe(clips)
        want = T._describe_chunked(_clip_call(seq, lock), {"batch": 4}, clips)
        assert got.dtype == want.dtype == np.float32 and got.tobytes() == want.tobytes()
        assert [c.tobytes() for c in calls] == [c.tobytes() for c in seq]
        assert co.snapshot() == {"dispatches": len(seq), "clips": n, "packed": 0}


def test_serve_every_op_with_error_isolation(art):
    """Every op over stdin/stdout; bad requests get ``ok: false`` and the
    loop goes on; an oversize line is drained and answered; nothing is
    served past shutdown."""
    p = art.path
    # queries = gallery clips 1 and 3 enrolled by describe below
    np.savez(p("q2.npz"), clips=art.clips[[1, 3]])
    reqs = [
        {"op": "ping"},
        "this is not json",
        {"op": "rank", "features": p("queries.npz")},                     # empty index
        {"op": "add", "clips": p("clips.npz")},                            # 6 described rows
        {"op": "add", "features": p("more.npz")},                          # 299 rows: crosses 256
        {"op": "add"},
        {"op": "describe", "clips": p("q2.npz"), "out": p("q2f.npz")},
        {"op": "describe", "clips": p("q2.npz")},
        {"op": "rank", "clips": p("q2.npz"), "topk": 3},
        {"op": "rank", "clips": p("q2.npz"), "topk": 0},
        {"op": "rank", "features": p("queries.npz"), "rerank": True, "topk": 4},
        {"op": "rank", "features": p("queries5.npz"), "rerank": True},    # 5 > query width 4
        "x" * 3000,                                                        # oversize (cap ~2 KB)
        {"op": "add", "features": p("queries.npz")},                       # over capacity
        {"op": "frobnicate"},
        {"op": "stats"},
        {"op": "save", "out": p("index.npz")},
        {"op": "shutdown"},
        {"op": "ping"},
    ]
    resps = port_serve(["--model", art.port, "--capacity", "305", "--topk", "4", "--rerank-queries", "4",
                        "--max-request-mb", "0.002", "--warmup"], reqs)
    (ping, bad, empty, add_clips, add_more, add_none, desc, desc_inline, rank, rank_k0, rr, wide, oversize,
     overflow, unknown, stats, save, bye) = resps
    assert ping == {"ok": True, "op": "ping", "dim": DIM, "batch": 4, "seq_len": 2, "height": 64, "width": 32,
                    "channels": 3, "platform": "cpu", "gallery": 0, "capacity": 305, "rerank": True,
                    "rerank_queries": 4, "rerank_staged": False, "rerank_devices": 1, "ms": ping["ms"]}
    assert not bad["ok"] and "JSONDecodeError" in bad["error"]
    assert not empty["ok"] and "empty" in empty["error"]
    assert add_clips["gallery"] == 6 and add_more["gallery"] == 305 and add_more["added"] == 299
    assert not add_none["ok"] and "npz path" in add_none["error"]
    assert desc["n"] == 2 and desc["out"] == p("q2f.npz")
    import base64

    inline = np.load(io.BytesIO(base64.b64decode(desc_inline["npz_b64"])))
    np.testing.assert_array_equal(inline["features"], np.load(p("q2f.npz"))["features"])
    assert [r["matches"][0]["gallery"] for r in rank["results"]] == [1, 3]  # themselves first
    assert all(len(r["matches"]) == 3 for r in rank["results"])
    assert not rank_k0["ok"] and "topk must be >= 1" in rank_k0["error"]
    assert rr["reranked"] and "warning" not in rr and len(rr["results"]) == 4
    assert not wide["ok"] and "--rerank-queries" in wide["error"]
    assert not oversize["ok"] and "max-request-mb" in oversize["error"]
    assert not overflow["ok"] and "capacity" in overflow["error"]
    assert not unknown["ok"] and "frobnicate" in unknown["error"] and unknown["op"] == "frobnicate"
    assert stats["ops"]["oversize"] == {"n": 1, "errors": 1, "ms_mean": 0.0, "ms_max": 0.0}
    assert stats["ops"]["rank"]["n"] == 5 and stats["gallery"] == 305
    assert stats["describe_batching"]["clips"] == 2 + 2 + 2 + 6 and stats["describe_batching"]["packed"] == 0
    assert save["n"] == 305 and bye == {"ok": True, "op": "shutdown", "ms": bye["ms"]}
    assert all("ms" in r for r in resps)

    # the index holds what was enrolled; the re-ranked answer is the host
    # form's over it
    from grl_tpu_torch.engine.evaluator import _euclidean, cosine_distance
    from grl_tpu_torch.engine.rerank import re_ranking_host

    index = np.load(p("index.npz"))
    np.testing.assert_array_equal(index["features"][6:], art.feats[40:339])
    assert list(index["pids"]) == list(range(6)) + list(range(40, 339))  # the clips npz carries pids
    qf, gf = torch.from_numpy(art.feats[339:343]), torch.from_numpy(index["features"])
    host = re_ranking_host(*(x.numpy() for x in (cosine_distance(qf, gf), _euclidean(qf, qf), _euclidean(gf, gf))))
    for qi, rec in enumerate(rr["results"]):
        got = [m["gallery"] for m in rec["matches"]]
        np.testing.assert_array_equal(got, np.argsort(host[qi], kind="stable")[:4])
        np.testing.assert_allclose([m["score"] for m in rec["matches"]], -host[qi][got], rtol=0, atol=1e-5)


def test_serve_staged_route_matches_padded_route(art, monkeypatch):
    """Past re-ranking's cut (``rerank.ONE_PROGRAM_MAX``, shrunk) the
    daemon re-ranks through the staged builder with valid counts: the same
    answers as the padded route."""
    argv = ["--model", art.port, "--gallery", art.path("gallery.npz"), "--capacity", "64", "--topk", "5",
            "--rerank-queries", "4", "--warmup"]
    reqs = [{"op": "ping"}, {"op": "add", "features": art.path("queries5.npz")},
            {"op": "rank", "features": art.path("queries.npz"), "rerank": True}]
    padded = port_serve(argv, reqs)
    monkeypatch.setattr(T.rerank, "ONE_PROGRAM_MAX", 8)
    staged = port_serve(argv, reqs)
    assert not padded[0]["rerank_staged"] and staged[0]["rerank_staged"]
    for a, b in zip(padded[2]["results"], staged[2]["results"]):
        assert [m["gallery"] for m in a["matches"]] == [m["gallery"] for m in b["matches"]]
        np.testing.assert_allclose([m["score"] for m in a["matches"]], [m["score"] for m in b["matches"]],
                                   rtol=0, atol=1e-5)


def test_same_script_same_answers_from_both_daemons(art):
    """One request script to grl_tpu's daemon (its jax.export artifact) and
    the port's: the same response keys, the same matches, scores within
    1e-4 (plain and re-ranked), describe within 1e-4."""
    reqs = [{"op": "ping"},
            {"op": "describe", "clips": art.path("clips.npz")},
            {"op": "add", "features": art.path("more.npz")},
            {"op": "rank", "features": art.path("queries.npz"), "topk": 5},
            {"op": "rank", "features": art.path("queries.npz"), "rerank": True, "topk": 5},
            {"op": "rank", "clips": art.path("clips.npz"), "topk": 3},
            {"op": "add", "features": art.path("more.npz")},
            {"op": "save"},
            {"op": "shutdown"}]
    argv = ["--gallery", art.path("gallery.npz"), "--capacity", "400", "--topk", "5", "--rerank-queries", "4"]
    port = port_serve(["--model", art.port, *argv], reqs)
    out = io.StringIO()
    J.serve(J.build_parser().parse_args(["serve", "--model", art.jax, *argv]),
            inp=io.StringIO("".join(json.dumps(r) + "\n" for r in reqs)), out=out)
    jax = [json.loads(line) for line in out.getvalue().splitlines()]
    assert len(port) == len(jax) == len(reqs)
    for got, want in zip(port, jax):
        assert sorted(got) == sorted(want), (got.get("op"), sorted(got), sorted(want))
        assert got["ok"] == want["ok"]
    assert {k: v for k, v in port[0].items() if k != "ms"} == {k: v for k, v in jax[0].items() if k != "ms"}

    def features(resp):
        import base64

        return np.load(io.BytesIO(base64.b64decode(resp["npz_b64"])))["features"]

    np.testing.assert_allclose(features(port[1]), features(jax[1]), rtol=0, atol=ATOL)
    for i in (3, 4, 5):
        for got, want in zip(port[i]["results"], jax[i]["results"]):
            assert [(m["gallery"], m["pid"], m["camid"]) for m in got["matches"]] == \
                [(m["gallery"], m["pid"], m["camid"]) for m in want["matches"]]
            np.testing.assert_allclose([m["score"] for m in got["matches"]], [m["score"] for m in want["matches"]],
                                       rtol=0, atol=ATOL)
    assert not port[6]["ok"] and not jax[6]["ok"]  # over capacity in both
    assert port[7]["n"] == jax[7]["n"] == 339


def _watchdog(proc, seconds=180):
    timer = threading.Timer(seconds, proc.kill)
    timer.daemon = True
    timer.start()
    return timer


@pytest.mark.parametrize("client", ["grl_tpu", "grl_tpu_torch"])
def test_either_client_spawns_and_drives_the_port_daemon(art, client, monkeypatch):
    if client == "grl_tpu":
        from grl_tpu.client import ServeClient
    else:
        from grl_tpu_torch.client import ServeClient
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    command = [sys.executable, "-m", "grl_tpu_torch.cli.extract", "--device", "cpu"]
    with ServeClient.spawn(art.port, gallery=art.path("gallery.npz"), topk=3, command=command,
                           stderr=subprocess.DEVNULL) as c:
        timer = _watchdog(c._proc)
        try:
            ping = c.ping()
            assert ping["platform"] == "cpu" and ping["gallery"] == 40
            got = c.describe(art.clips[:2], pids=np.array([7, 8]))
            assert got["features"].shape == (2, DIM) and list(got["pids"]) == [7, 8]
            hits = c.rank(features=art.feats[:2], topk=3)["results"]
            assert [r["matches"][0]["gallery"] for r in hits] == [0, 1]
            proc = c._proc
        finally:
            timer.cancel()
    assert proc.returncode == 0


def test_sigterm_stops_the_socket_daemon_cleanly(art, tmp_path):
    sock = str(tmp_path / "serve.sock")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.Popen([sys.executable, "-m", "grl_tpu_torch.cli.extract", "--device", "cpu", "serve",
                             "--model", art.port, "--listen", f"unix:{sock}"],
                            env=env, stderr=subprocess.PIPE, text=True)
    timer = _watchdog(proc)
    try:
        deadline = time.time() + 120
        while not osp.exists(sock):
            assert time.time() < deadline and proc.poll() is None
            time.sleep(0.05)
        import socket

        with socket.socket(socket.AF_UNIX) as c:
            c.connect(sock)
            c.sendall(b'{"op": "ping"}\n')
            assert json.loads(c.makefile("r").readline())["ok"]
        proc.send_signal(signal.SIGTERM)
        stderr = proc.communicate(timeout=120)[1]
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, stderr
    assert "caught signal 15" in stderr
    assert not osp.exists(sock)


def test_flags_are_grl_tpu_s_plus_device():
    def flags(parser):
        sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
        return {name: {a.dest: a.default for a in p._actions if a.dest != "help"} for name, p in sub.choices.items()}

    ours, theirs = flags(T.build_parser()), flags(J.build_parser())
    assert ours == theirs
    top = {a.dest: a.default for a in T.build_parser()._actions if a.dest not in ("help", "command")}
    assert top == {"device": "cuda"}


@pytest.mark.parametrize("argv", [["serve", "--devices", "2"], ["export-model", "--use-flow"]],
                         ids=["serve-devices", "export-use-flow"])
def test_unported_flags_exit_naming_their_roadmap_item(art, argv):
    """Both flags are ported: ``serve --devices 2`` re-ranks on two gloo
    ranks through the staged route and says so in its ping (its answers
    are held in ``tests/test_torch_parallel_serve.py``); ``export-model
    --use-flow`` exports a 6-channel program from a flow checkpoint."""
    if argv[0] == "serve":
        ping, rr, _ = port_serve([*argv[1:], "--model", art.port, "--gallery", art.path("gallery.npz"),
                                  "--rerank-queries", "4"],
                                 [{"op": "ping"}, {"op": "rank", "features": art.path("queries.npz"), "rerank": True},
                                  {"op": "shutdown"}])
        assert ping["rerank_devices"] == 2 and ping["rerank_staged"]
        assert rr["ok"] and rr["reranked"] and len(rr["results"]) == 4
        return
    out = art.path("flow_model.npz")
    meta = port_main(*argv, "--checkpoint", art.flow_ckpt, *EXPORT, "-o", out)
    assert meta["channels"] == 6 and meta["dim"] == DIM
    assert json.loads(str(np.load(out)["meta"]))["channels"] == 6
