"""The serve daemon's transport: JSON lines over stdin/stdout or a socket.

``Transport(listen, max_request_mb).run(handle, inp, out)`` answers each
request line with the response ``handle(req)`` returns, and knows nothing
of what the requests ask. Around ``handle`` it caps a line's size, answers
a request that raises with an error, adds ``ms`` (from before
``json.loads`` to after ``handle``), counts each op (``stats``), opens
``serve.request`` around a ``rank`` request and adds its spans when traced,
and stops on a shutdown op, SIGTERM or SIGINT. ``cli.extract.serve``
documents the protocol.
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import socket as socklib
import sys
import threading
import time

from ..utils.profiling import span


class Transport:
    """One daemon's transport: its stop flag, socket, connections and stats."""

    def __init__(self, listen="", max_request_mb=256.0):
        self.listen, self.max_request_mb = listen, max_request_mb
        # request lines are read with a hard size cap: inline operands ride
        # base64-npz on the line, so an unbounded readline would let one
        # client balloon host memory before json.loads runs
        self._max_chars = int(max_request_mb * (1 << 20))
        self.stopping = False
        self._srv = None
        self._conns = set()
        self._lock = threading.Lock()  # the connections and the stats
        self._stats = {}
        self._t0 = self._sig_w = None

    def stats(self):
        """Per-op counts and milliseconds (lock waits included), and the uptime."""
        with self._lock:
            ops = {
                name: {"n": s["n"], "errors": s["errors"],
                       "ms_mean": round(s["ms_total"] / s["n"], 2),
                       "ms_max": s["ms_max"]}
                for name, s in self._stats.items()
            }
        return {"ops": ops, "uptime_s": round(time.time() - self._t0, 1)}

    def _count(self, op, ok, ms):
        with self._lock:
            s = self._stats.setdefault(op, {"n": 0, "errors": 0, "ms_total": 0.0, "ms_max": 0.0})
            s["n"] += 1
            s["errors"] += 0 if ok else 1
            s["ms_total"] += ms
            s["ms_max"] = max(s["ms_max"], ms)

    def run(self, handle, inp, out):
        """Serve until EOF on ``inp`` (without ``listen``), a shutdown op or
        a signal; returns the number of requests answered."""
        self._t0 = time.time()
        # Self-pipe teardown: the signal handler may interrupt a holder of
        # any non-reentrant lock on the main thread, so it takes no lock,
        # starts no thread and prints nothing. It sets the stop flag and
        # pokes a pipe (os.write is async-signal-safe); a pre-spawned waiter
        # thread blocked in os.read runs the socket teardown.
        sig_r, self._sig_w = os.pipe()

        def wait_for_signal():
            data = os.read(sig_r, 1)
            if data:  # empty read = pipe closed on the no-signal exit path
                self.stop(f"caught signal {int(data[0])}")

        prev_handlers, waiter = {}, None
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                prev_handlers[sig] = signal.signal(sig, self._on_signal)
            waiter = threading.Thread(target=wait_for_signal, daemon=True)
            waiter.start()
        except ValueError:  # not the main thread
            prev_handlers = {}
        try:
            if not self.listen:
                return self._lines(handle, inp, out)[0]
            return self._accept(handle)
        finally:
            for sig, handler in prev_handlers.items():
                signal.signal(sig, handler)
            # unblock the signal waiter (os.read returns b"" on writer close)
            # and wait for it: a signal that lands while the accept loop is
            # between two accept() calls stops the loop through the flag
            # alone, and the waiter must still run its teardown and log
            # before the process ends
            try:
                os.close(self._sig_w)
            except OSError:
                pass
            if waiter is not None:
                waiter.join(timeout=10)
            if waiter is None or not waiter.is_alive():
                os.close(sig_r)

    def _on_signal(self, signum, _frame):
        self.stopping = True
        try:
            os.write(self._sig_w, bytes([signum]))
        except OSError:
            pass  # pipe already closed during shutdown

    def stop(self, why):
        """Finish in-flight requests, then exit cleanly. Blocked syscalls
        must FAIL rather than be retried (PEP 475 retries after a signal
        handler returns): full shutdown on the listening socket aborts
        accept(); read-side shutdown on live connections turns their
        blocked readline into EOF while each response side still flushes."""
        self.stopping = True
        print(f"{why}: shutting down", file=sys.stderr)
        if self._srv is not None:
            try:
                self._srv.shutdown(socklib.SHUT_RDWR)
            except OSError:
                pass
        with self._lock:
            live = list(self._conns)
        for conn in live:
            try:
                conn.shutdown(socklib.SHUT_RD)
            except OSError:
                pass

    def _read_bounded_line(self, fin):
        """readline with a cap; returns (line, oversize?)."""
        line = fin.readline(self._max_chars + 1)
        if len(line) <= self._max_chars or line.endswith("\n"):
            return line, False
        while True:  # discard the rest of the oversize line, 1 MiB at a time
            chunk = fin.readline(1 << 20)
            if not chunk or chunk.endswith("\n"):
                return "", True

    def _lines(self, handle, fin, fout):
        """One JSON-lines conversation; returns (#served, shutdown?)."""
        served = 0
        while True:
            line, oversize = self._read_bounded_line(fin)
            if oversize:
                resp = {
                    "ok": False,
                    "error": f"request line exceeds --max-request-mb "
                             f"({self.max_request_mb:g} MB); send large "
                             f"operands as file paths instead of inline "
                             f"npz_b64, or raise the cap",
                    "ms": 0.0,
                }
                self._count("oversize", False, 0.0)
                fout.write(json.dumps(resp) + "\n")
                fout.flush()  # OSError here = client vanished; conversation logs it
                continue
            if not line:  # EOF
                break
            line = line.strip()
            if not line:
                continue
            t0 = time.perf_counter()
            req = None
            with contextlib.ExitStack() as scope:
                request = None
                try:
                    req = json.loads(line)
                    if isinstance(req, dict) and req.get("op") == "rank":
                        request = scope.enter_context(span("serve.request"))
                    resp = handle(req)
                except Exception as e:  # noqa: BLE001 — per-request isolation
                    resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                    if isinstance(req, dict):  # attribute the error to its op
                        resp["op"] = req.get("op")
                resp["ms"] = round((time.perf_counter() - t0) * 1e3, 2)
                done = request.descendants() if request is not None else None
                if done:  # a traced request's spans so far (not its own)
                    resp["spans"] = [list(sp) for sp in done]
                self._count(resp.get("op") or "invalid", resp.get("ok"), resp["ms"])
                # decide BEFORE the reply write: a client that disconnects
                # without reading its shutdown response must still stop the daemon
                stopping = (resp.get("op") == "shutdown" and resp.get("ok")) or self.stopping
                try:
                    fout.write(json.dumps(resp) + "\n")
                    fout.flush()
                    served += 1
                except OSError:
                    if not stopping:
                        raise  # client vanished mid-reply; conversation logs it
            if stopping:
                return served, True
        return served, False

    def _accept(self, handle):
        """Socket mode: clients connect and disconnect freely, each served
        on its own thread, so an idle client blocks no other's requests. TCP
        binds are for trusted networks (no auth); unix:PATH scopes by file
        permissions."""
        if self.listen.startswith("unix:"):
            path = self.listen[5:]
            try:
                os.unlink(path)
            except OSError:
                pass
            srv = socklib.socket(socklib.AF_UNIX)
            srv.bind(path)
            bound = self.listen
        else:
            host, _, port = self.listen.rpartition(":")
            srv = socklib.socket(socklib.AF_INET)
            srv.setsockopt(socklib.SOL_SOCKET, socklib.SO_REUSEADDR, 1)
            srv.bind((host or "127.0.0.1", int(port)))
            bound = "%s:%d" % srv.getsockname()[:2]  # resolves port 0
        srv.listen(16)
        # accept() wakes every half second to read the stop flag: shutting a
        # listening socket down does not wake a blocked accept() on every
        # kernel (some refuse it with ENOTCONN)
        srv.settimeout(0.5)
        self._srv = srv
        print(f"listening on {bound}", file=sys.stderr, flush=True)
        n_req = [0]
        threads = []

        def conversation(conn):
            stopped = False
            with conn:
                try:
                    served, stopped = self._lines(handle, conn.makefile("r", encoding="utf-8"),
                                                  conn.makefile("w", encoding="utf-8"))
                    with self._lock:
                        n_req[0] += served
                except OSError as e:  # client vanished mid-reply
                    print(f"client dropped: {e}", file=sys.stderr)
                finally:
                    with self._lock:
                        self._conns.discard(conn)
            if stopped and not self.stopping:
                self.stop("shutdown op")  # from any client

        try:
            while not self.stopping:
                try:
                    conn, _peer = srv.accept()
                except socklib.timeout:
                    continue
                except OSError:
                    if self.stopping:  # stop() aborted accept
                        break
                    raise
                with self._lock:
                    self._conns.add(conn)
                if self.stopping:
                    # raced stop()'s connection snapshot: deliver the EOF it
                    # would have sent, or this reader blocks forever
                    try:
                        conn.shutdown(socklib.SHUT_RD)
                    except OSError:
                        pass
                t = threading.Thread(target=conversation, args=(conn,), daemon=True)
                t.start()
                # reap finished conversations so a long-lived daemon's
                # thread list does not grow with every connection
                threads[:] = [x for x in threads if x.is_alive()]
                threads.append(t)
            for t in threads:  # in-flight requests finish; readers got EOF
                t.join()
        finally:
            srv.close()
            if self.listen.startswith("unix:"):
                try:
                    os.unlink(self.listen[5:])
                except OSError:
                    pass
        return n_req[0]
