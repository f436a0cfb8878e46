"""``serve --devices 2`` and ``cli.evaluate --devices 2 --rerank 1`` on the
CPU: the row-sharded re-ranking behind the port's entry points, over two
gloo ranks, against one rank and against grl_tpu's ``--devices 2`` (a
2-device mesh of the 8-device virtual CPU mesh, ``tests/conftest.py``).

The port's daemon runs in this process as rank 0 (its request script on
a StringIO stdin), its second rank started beside it; the SIGTERM case
runs it as ``python -m grl_tpu_torch.cli.extract`` on a unix socket, under
a watchdog. The artifacts are both packages' exports of one tiny grl_tpu
checkpoint (``tests/test_torch_extract.py``'s geometry); the index holds
40 unit features, and 299 more are enrolled.

Bounds: re-ranked scores within 1e-5 of ``--devices 1`` on the staged
route (the kernel's tolerance; the same sums in another order) and within
1e-4 of grl_tpu's daemon (``tests/test_torch_extract.py``'s bound for the
two packages), with the same matches; ``cli.evaluate``'s rank-1 and mAP
lines equal grl_tpu's.
"""

import io
import json
import os
import os.path as osp
import signal
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

sys.path.insert(0, osp.dirname(__file__))

from grl_tpu.cli import evaluate as j_eval  # noqa: E402
from grl_tpu.cli import extract as J  # noqa: E402
from grl_tpu_torch.cli import extract as T  # noqa: E402
from grl_tpu_torch.client import ServeClient  # noqa: E402
from test_torch_extract import DIM, EXPORT, jax_main, port_main, port_serve  # noqa: E402

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
TOL, JAX_TOL = 1e-5, 1e-4
TIMEOUT = 150


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    """A tiny grl_tpu checkpoint (4 classes), each package's artifact of it,
    an index of 40 unit features, 299 to enroll and 4 queries."""
    import jax

    from grl_tpu.cli.train import build_models
    from grl_tpu.engine.optim import SGD
    from grl_tpu.engine.train_step import init_train_state
    from grl_tpu.utils.serialization import save_train_state

    tmp = tmp_path_factory.mktemp("serve_devices")
    cnn, sia, unc = build_models(SimpleNamespace(bf16=False, use_flow=False, arch2="siamese"), tiny=True)
    ckpt = str(tmp / "checkpoint.npz")
    save_train_state(init_train_state(jax.random.PRNGKey(0), cnn, sia, unc, 4, cnn.num_feat, SGD()),
                     {"epoch": 1, "best_top1": 0.0}, ckpt)
    port_main("export-model", "--checkpoint", ckpt, *EXPORT, "-o", str(tmp / "port.npz"))
    jax_main("export-model", "--checkpoint", ckpt, *EXPORT, "-o", str(tmp / "jax.npz"))
    rng = np.random.RandomState(0)
    feats = rng.randn(343, DIM).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    np.savez(tmp / "gallery.npz", features=feats[:40], pids=np.arange(40), camids=np.arange(40) % 2)
    np.savez(tmp / "more.npz", features=feats[40:339], pids=np.arange(40, 339), camids=np.arange(299) % 6)
    np.savez(tmp / "queries.npz", features=feats[339:343])
    return SimpleNamespace(dir=tmp, ckpt=ckpt, port=str(tmp / "port.npz"), jax=str(tmp / "jax.npz"),
                           path=lambda name: str(tmp / name))


REQUESTS = lambda art: [  # noqa: E731
    {"op": "ping"},
    {"op": "rank", "features": art.path("queries.npz"), "rerank": True, "topk": 5},
    {"op": "add", "features": art.path("more.npz")},
    {"op": "rank", "features": art.path("queries.npz"), "topk": 5},
    {"op": "rank", "features": art.path("queries.npz"), "rerank": True, "topk": 5},
    {"op": "shutdown"},
]
ARGV = ["--topk", "5", "--rerank-queries", "4", "--capacity", "400"]


def _reranked(resp):
    return ([[m["gallery"] for m in r["matches"]] for r in resp["results"]],
            np.array([[m["score"] for m in r["matches"]] for r in resp["results"]]))


def test_serve_devices_2_equals_one_rank_and_grl_tpu(art, monkeypatch):
    """One request script (re-rank, enroll 299 rows, rank, re-rank) to the
    port's daemon on 2 ranks, on 1 rank on the staged route, and to
    grl_tpu's daemon on a 2-device mesh: the same matches, scores within
    1e-5 of one rank and 1e-4 of grl_tpu. The re-rank after the enrollment
    equals one rank's only if the second rank took the enrolled rows."""
    reqs = REQUESTS(art)
    argv = ["--gallery", art.path("gallery.npz"), *ARGV]
    two = port_serve(["--model", art.port, *argv, "--devices", "2"], reqs)
    monkeypatch.setattr(T.rerank, "ONE_PROGRAM_MAX", 8)  # one rank on the staged route
    one = port_serve(["--model", art.port, *argv], reqs)
    out = io.StringIO()
    J.serve(J.build_parser().parse_args(["serve", "--model", art.jax, *argv, "--devices", "2"]),
            inp=io.StringIO("".join(json.dumps(r) + "\n" for r in reqs)), out=out)
    jax = [json.loads(line) for line in out.getvalue().splitlines()]
    assert len(two) == len(one) == len(jax) == len(reqs) and all(r["ok"] for r in two)
    assert two[0]["rerank_devices"] == jax[0]["rerank_devices"] == 2
    assert two[0]["rerank_staged"] and jax[0]["rerank_staged"]
    assert {k: v for k, v in two[0].items() if k != "ms"} == {k: v for k, v in jax[0].items() if k != "ms"}
    assert two[2]["gallery"] == 339
    for i in (1, 4):
        got, want_one, want_jax = _reranked(two[i]), _reranked(one[i]), _reranked(jax[i])
        assert two[i]["reranked"] and got[0] == want_one[0] == want_jax[0]
        np.testing.assert_allclose(got[1], want_one[1], rtol=0, atol=TOL)
        np.testing.assert_allclose(got[1], want_jax[1], rtol=0, atol=JAX_TOL)
    assert _reranked(two[3])[0] == _reranked(one[3])[0]


def test_serve_devices_2_stops_both_ranks_on_sigterm(art, tmp_path):
    """The daemon on a unix socket with 2 ranks: a re-ranked request, then
    SIGTERM to the daemon's process: rank 0 finishes, stops the group, and
    the second rank leaves after its request; the process exits 0 and
    removes its socket."""
    sock = str(tmp_path / "serve.sock")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.Popen([sys.executable, "-m", "grl_tpu_torch.cli.extract", "--device", "cpu", "serve",
                             "--model", art.port, "--gallery", art.path("gallery.npz"), *ARGV, "--devices", "2",
                             "--listen", f"unix:{sock}"],
                            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        deadline = time.time() + TIMEOUT
        while not osp.exists(sock):
            assert proc.poll() is None and time.time() < deadline, proc.communicate()[1][-3000:]
            time.sleep(0.1)
        with ServeClient.connect(f"unix:{sock}", timeout=TIMEOUT) as c:
            assert c.ping()["rerank_devices"] == 2
            assert c.rank(features=np.load(art.path("queries.npz"))["features"], topk=3, rerank=True)["reranked"]
        proc.send_signal(signal.SIGTERM)
        stderr = proc.communicate(timeout=TIMEOUT)[1]
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    assert proc.returncode == 0, stderr[-3000:]
    assert "caught signal 15" in stderr
    assert "serve rank 1 of 2: stopped by rank 0 after 1 re-ranked requests" in stderr
    assert not osp.exists(sock)


def test_cli_evaluate_devices_2_rerank_equals_grl_tpu(art, tmp_path):
    """``cli.evaluate --devices 2 --rerank 1`` (2 gloo ranks, each describing
    its stripe, the tail sharded) and grl_tpu's on a 2-device mesh, on one
    checkpoint: the same rank-1 and mAP lines."""
    common = ["-d", "synthetic", "--tiny", "--seq_len", "2", "-j", "1", "--seed", "0",
              "--checkpoint", art.ckpt, "--rerank", "1", "--devices", "2"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "grl_tpu_torch.cli.evaluate", *common, "--device", "cpu",
                           "--logs-dir", str(tmp_path / "port")], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    j_eval.main(j_eval.build_parser().parse_args([*common, "--logs-dir", str(tmp_path / "jax")]))

    def report(run):
        text = (tmp_path / run / "log_test0.txt").read_text()
        return [line for line in text.splitlines() if line.startswith(("Mean AP", "Rank-"))]

    assert "Mesh(rank=1, size=2" in (tmp_path / "port" / "log_test0.p1.txt").read_text()
    assert len(report("port")) >= 3 and report("port") == report("jax")
