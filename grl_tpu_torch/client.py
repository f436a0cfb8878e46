"""Python client for the ``extract serve`` daemon (the port's copy of
``grl_tpu/client.py``; the wire protocol is the same, so either package's
client drives either package's daemon).

The daemon (``grl_tpu_torch/cli/extract.py::serve``) speaks a JSON-lines
protocol — one request object per line, one response per line — over
stdin/stdout or a TCP/unix socket. This module wraps it with a
numpy-in/numpy-out API so application code never touches the wire
format:

    from grl_tpu_torch.client import ServeClient

    with ServeClient.connect("reid-host:7012") as c:
        feats = c.describe(clips)["features"]        # (n, 6144) float32
        hits = c.rank(clips, topk=10, rerank=True)["results"]

    # or own the daemon's lifecycle (stdin/stdout pipes, no socket):
    with ServeClient.spawn(model="model.npz", gallery="gal.npz") as c:
        c.ping()

Array arguments are encoded as inline npz payloads (``npz_b64``), so a
socket client needs NO shared filesystem with the daemon; string
arguments pass through as daemon-side paths (the zero-copy handoff when
the filesystem IS shared). Responses with ``{"ok": false}`` raise
:class:`ServeError`; transport failures raise :class:`ServeError` with
``op=None``.

The serving layer has no reference analogue (flysnowtiger/GRL stops at
offline evaluation); the protocol itself is documented on ``serve``'s
docstring and README.md.
"""

from __future__ import annotations

import base64
import io
import json
import os
import socket as socklib
import subprocess
import sys

import numpy as np

__all__ = ["ServeClient", "ServeError"]


class ServeError(RuntimeError):
    """A daemon-reported failure (``{"ok": false}``) or transport loss.

    ``op`` is the failing operation when the daemon attributed one,
    else None (malformed request / dead transport)."""

    def __init__(self, message, op=None):
        super().__init__(message)
        self.op = op


def _inline_npz(arrays):
    """Arrays -> the protocol's inline operand {"npz_b64": ...}."""
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return {"npz_b64": base64.b64encode(buf.getvalue()).decode("ascii")}


def _decode_npz(b64):
    """Inline response body -> {name: array}."""
    src = np.load(io.BytesIO(base64.b64decode(b64)))
    return {k: src[k] for k in src.files}


def _operand(value, key, labels=None):
    """A user-facing npz argument: a daemon-side path string passes
    through; an array is bundled (with optional labels) into an inline
    payload."""
    if isinstance(value, (str, os.PathLike)):
        if labels and any(v is not None for v in labels.values()):
            raise ValueError(
                f"labels can only ride with an in-memory {key} array — "
                "put them inside the npz when passing a path"
            )
        return str(value)
    arrays = {key: np.asarray(value)}
    for name, v in (labels or {}).items():
        if v is not None:
            arrays[name] = np.asarray(v)
    return _inline_npz(arrays)


class ServeClient:
    """One connection (or one owned subprocess) to a serve daemon.

    Build with :meth:`connect` (socket) or :meth:`spawn` (subprocess
    over stdin/stdout pipes); both are context managers. Device work is
    serialized daemon-side, and THIS object is not thread-safe — use one
    client per thread (the daemon serves connections concurrently)."""

    def __init__(self, fin, fout, *, proc=None, sock=None):
        self._fin, self._fout = fin, fout
        self._proc, self._sock = proc, sock
        self._closed = False

    # -- constructors -----------------------------------------------------

    @classmethod
    def connect(cls, address, timeout=None):
        """Connect to ``serve --listen``: ``"unix:/path"`` or
        ``"host:port"``. ``timeout`` (seconds) applies to connect AND to
        every response read — size it for the slowest expected request
        (a cold rerank can be minutes; warmed daemons answer in ms)."""
        if address.startswith("unix:"):
            sock = socklib.socket(socklib.AF_UNIX)
            sock.settimeout(timeout)
            sock.connect(address[5:])
        else:
            host, _, port = address.rpartition(":")
            sock = socklib.create_connection(
                (host or "127.0.0.1", int(port)), timeout=timeout)
        fin = sock.makefile("r", encoding="utf-8")
        fout = sock.makefile("w", encoding="utf-8")
        return cls(fin, fout, sock=sock)

    @classmethod
    def spawn(cls, model, *, gallery=None, capacity=None, topk=None,
              rerank_queries=None, devices=None, warmup=False,
              command=None, stderr=None):
        """Start a daemon subprocess and talk to it over pipes.

        ``command`` overrides the interpreter prefix (default
        ``[sys.executable, "-m", "grl_tpu_torch.cli.extract"]``) — e.g.
        with ``"--device", "cpu"`` appended to serve on the host. ``stderr``
        passes to :class:`subprocess.Popen` (daemon logs land there;
        default: inherit). The daemon dies with this client: close()
        sends shutdown and reaps it."""
        argv = list(command or [sys.executable, "-m", "grl_tpu_torch.cli.extract"])
        argv += ["serve", "--model", str(model)]
        for flag, value in (("--gallery", gallery), ("--capacity", capacity),
                            ("--topk", topk),
                            ("--rerank-queries", rerank_queries),
                            ("--devices", devices)):
            if value is not None:
                argv += [flag, str(value)]
        if warmup:
            argv.append("--warmup")
        proc = subprocess.Popen(argv, stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, stderr=stderr,
                                text=True, encoding="utf-8")
        return cls(proc.stdout, proc.stdin, proc=proc)

    # -- protocol core -----------------------------------------------------

    def request(self, op, **fields):
        """Send one request, block for its response; raise
        :class:`ServeError` unless ``ok`` is true. The ``spans`` of a
        profiled daemon's response are recorded in this process
        (``utils.profiling.record``) and taken off the response."""
        if self._closed:
            raise ServeError("client is closed")
        req = {"op": op, **fields}
        try:
            self._fout.write(json.dumps(req) + "\n")
            self._fout.flush()
            line = self._fin.readline()
        except OSError as e:
            raise ServeError(f"transport lost during {op!r}: {e}") from e
        if not line:  # EOF: daemon stopped (or died) mid-conversation
            raise ServeError(f"daemon closed the connection during {op!r}")
        resp = json.loads(line)
        spans = resp.pop("spans", None)
        if spans is not None:  # a profiled daemon's spans of this request
            from .utils.profiling import record

            record(spans)
        if not resp.get("ok"):
            raise ServeError(resp.get("error", "unknown daemon error"),
                             op=resp.get("op"))
        return resp

    # -- ops ---------------------------------------------------------------

    def ping(self):
        """Daemon + index config: dim/batch/gallery/capacity and the
        rerank surface (available? staged? how many devices?)."""
        return self.request("ping")

    def stats(self):
        """Per-op request counters + latency aggregates, uptime."""
        return self.request("stats")

    def describe(self, clips, *, pids=None, camids=None, out=None):
        """Clips -> 6144-d descriptors.

        ``clips``: a (n, seq_len, H, W, C) uint8 array (shipped inline)
        or a daemon-side npz path. ``pids``/``camids`` ride along with
        an array and come back in the result (label passthrough, same as
        the one-shot subcommand). Returns ``{"features": (n, dim)
        float32, ...labels}`` decoded from the inline response — unless
        ``out`` names a DAEMON-side npz path to write instead (then the
        raw response dict is returned)."""
        spec = _operand(clips, "clips", {"pids": pids, "camids": camids})
        if out is not None:
            return self.request("describe", clips=spec, out=str(out))
        return _decode_npz(self.request("describe", clips=spec)["npz_b64"])

    def rank(self, clips=None, *, features=None, topk=None, rerank=False):
        """Rank queries against the daemon's resident index: raw
        ``clips`` (described on device first) or precomputed
        ``features`` (a (n, dim) float32 array / daemon-side npz path —
        skips the CNN pass).

        Returns the response dict: ``results`` is one record per query
        — ``{"query": i, "matches": [{"gallery", "pid", "camid",
        "score"}, ...]}`` — plus ``reranked``/``warning`` when
        k-reciprocal re-ranking ran (rerank scores are ordinal only; see
        the serve docstring)."""
        if (clips is None) == (features is None):
            raise ValueError("rank takes exactly one of clips / features=")
        if clips is not None:
            fields = {"clips": _operand(clips, "clips")}
        else:
            fields = {"features": _operand(features, "features")}
        if topk is not None:
            fields["topk"] = int(topk)
        if rerank:
            fields["rerank"] = True
        return self.request("rank", **fields)

    def add(self, features=None, *, clips=None, pids=None, camids=None):
        """Enroll into the resident index (grows in place, never
        recompiles): pass descriptors via ``features`` or raw clips via
        ``clips`` — arrays or daemon-side paths, labels as in
        :meth:`describe`."""
        if (features is None) == (clips is None):
            raise ValueError("add takes exactly one of features= / clips=")
        labels = {"pids": pids, "camids": camids}
        if features is not None:
            return self.request(
                "add", features=_operand(features, "features", labels))
        return self.request("add", clips=_operand(clips, "clips", labels))

    def save(self, out=None):
        """Persist the (grown) index: to a DAEMON-side npz path, or —
        with no ``out`` — fetched inline as ``{"features", "pids",
        "camids"}`` arrays (mind the size: n x dim fp32 rides one
        base64 JSON line)."""
        if out is not None:
            return self.request("save", out=str(out))
        return _decode_npz(self.request("save")["npz_b64"])

    def shutdown(self):
        """Stop the DAEMON (all clients get EOF), then close this
        client."""
        try:
            return self.request("shutdown")
        finally:
            self.close()

    # -- lifecycle ---------------------------------------------------------

    def close(self):
        """Drop the connection. For :meth:`spawn` clients this shuts the
        daemon down (polite op first, then EOF on its stdin) and reaps
        the subprocess."""
        if self._closed:
            return
        self._closed = True
        if self._proc is not None and self._proc.poll() is None:
            try:
                self._fout.write(json.dumps({"op": "shutdown"}) + "\n")
                self._fout.flush()
            except OSError:
                pass  # already dying; EOF below is the backstop
        for f in (self._fin, self._fout):
            try:
                f.close()
            except OSError:
                pass
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        if self._proc is not None:
            try:
                self._proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
