"""TCP merge coordination: claim and exchange of merge-tree subgraphs
between build workers that share no filesystem. The port's copy of
pangraph_tpu/parallel/coordinator.py, with the same protocol and semantics,
reading graphs with the port's `Pangraph`.

`--coordinate tcp://HOST:PORT` replaces the shared-filesystem claim files of
`MergeCheckpointer` with a small in-memory coordination server: the first
worker to bind HOST:PORT hosts it on a daemon thread (host 0); every other
worker connects as a client. The client exposes the interface of
`MergeCheckpointer` (fingerprint / try_claim / wait_for / load / save), so
`build/build.py` uses it unchanged.

Protocol: one short-lived connection per op; a 4-byte big-endian length,
then a JSON header, then an optional raw payload (gzipped graph JSON).

  claim {key, stale_s, tok} -> {ok}   atomic claim; stale claims reassigned;
                                      idempotent per worker token (a retried
                                      claim after a dropped response succeeds)
  put   {key, len}+payload -> {ok}    publish a merged subgraph; wakes waiters
  get   {key} -> {len}+payload|{len:0}   non-blocking fetch
  wait  {key, timeout_s} -> {len}+payload   blocks until published

The hosting process registers an atexit drain: it does not tear the server
down while another worker is still blocked in `wait` for a key that was (or
is about to be) published, so the claimer of the final merge cannot exit
before its peers have received the root graph.

SECURITY: the protocol is unauthenticated by design (it coordinates trusted
workers of one build): bind HOST to a loopback or private, trusted network
interface only, never an internet-facing one. Per-message payloads are
capped at PANGRAPH_TPU_COORD_MAX_BYTES (default 1 GiB) and the retained
subgraph bytes at PANGRAPH_TPU_COORD_RETAIN_BYTES (default 4 GiB; the oldest
published graphs are evicted first, which is safe, because a missing
subgraph only means the asking worker recomputes that merge locally).
"""
from __future__ import annotations

import atexit
import gzip
import io
import json
import logging
import os
import socket
import struct
import threading
import time
import uuid

log = logging.getLogger(__name__)

_HDR = struct.Struct(">I")


def _send_msg(sock: socket.socket, header: dict, payload: bytes = b"") -> None:
    raw = json.dumps(header).encode()
    sock.sendall(_HDR.pack(len(raw)) + raw + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("coordinator connection closed")
        buf.extend(chunk)
    return bytes(buf)


def _recv_msg(sock: socket.socket, max_payload: int = None):
    (n,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
    if n > 1 << 20:  # the header is a small JSON dict; anything bigger is garbage
        raise ConnectionError(f"coordinator header too large ({n} bytes)")
    header = json.loads(_recv_exact(sock, n).decode())
    plen = int(header.get("len") or 0)
    if plen < 0 or (max_payload is not None and plen > max_payload):
        raise ConnectionError(f"coordinator payload too large ({plen} bytes)")
    payload = _recv_exact(sock, plen) if plen else b""
    return header, payload


class CoordinatorServer:
    """In-memory claim and exchange state behind a threaded TCP accept loop.

    Unauthenticated: bind to loopback or a trusted network only (see the
    module docstring). Per-message payloads are capped; the retained
    subgraph bytes are bounded by evicting the oldest published graphs (a
    worker asking for an evicted key recomputes that merge)."""

    MAX_PAYLOAD = int(float(os.environ.get("PANGRAPH_TPU_COORD_MAX_BYTES", 1 << 30)))
    RETAIN_BYTES = int(float(os.environ.get("PANGRAPH_TPU_COORD_RETAIN_BYTES", 4 << 30)))

    def __init__(self, host: str, port: int):
        self._lock = threading.Condition()
        self._claims: dict = {}  # key -> (claim time, worker token)
        self._graphs: dict = {}  # key -> payload bytes (insertion-ordered)
        self._graph_bytes = 0
        self._waiters = 0  # open `wait` connections (the drain barrier)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        # SO_REUSEADDR lets a restarted host 0 re-bind past TIME_WAIT remnants
        # of its predecessor's per-op connections; it does not allow two
        # listeners at once, so the first bind still elects exactly one server
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._sock.bind((host, port))
            self._sock.listen(64)
        except OSError:
            self._sock.close()
            raise
        self._sock.settimeout(0.5)
        self._stop = False
        threading.Thread(target=self._serve, daemon=True, name="merge-coordinator").start()
        atexit.register(self.drain)

    def _serve(self) -> None:
        while not self._stop:
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._handle, args=(conn,), daemon=True).start()

    def _handle(self, conn: socket.socket) -> None:
        try:
            with conn:
                header, payload = _recv_msg(conn, max_payload=self.MAX_PAYLOAD)
                op, key = header["op"], header.get("key")
                if op == "claim":
                    tok = header.get("tok")
                    with self._lock:
                        entry = self._claims.get(key)
                        fresh = entry is not None and time.time() - entry[0] <= header.get("stale_s", 3600.0)
                        done = key in self._graphs
                        # idempotent per worker token: a claim retried after a
                        # dropped response must succeed for its own holder, or
                        # the real claimant blocks on a merge nobody computes
                        mine = fresh and tok is not None and entry[1] == tok
                        ok = (not fresh or mine) and not done
                        if ok:
                            self._claims[key] = (time.time(), tok)
                    _send_msg(conn, {"ok": ok})
                elif op == "put":
                    with self._lock:
                        if key not in self._graphs:
                            self._graph_bytes += len(payload)
                        else:
                            self._graph_bytes += len(payload) - len(self._graphs.pop(key))
                        self._graphs[key] = payload
                        # bound host 0's memory: evict the oldest published
                        # graphs (consumed early in the merge tree; evicting
                        # one only costs the asker a local recompute)
                        while self._graph_bytes > self.RETAIN_BYTES and len(self._graphs) > 1:
                            old_key = next(iter(self._graphs))
                            if old_key == key:
                                break
                            self._graph_bytes -= len(self._graphs.pop(old_key))
                        self._lock.notify_all()
                    _send_msg(conn, {"ok": True})
                elif op == "get":
                    data = self._graphs.get(key, b"")
                    _send_msg(conn, {"len": len(data)}, data)
                elif op == "wait":
                    deadline = time.time() + header.get("timeout_s", 3600.0)
                    # the waiter count stays raised until the payload has been
                    # sent: the atexit drain of the hosting worker would
                    # otherwise release (and the process exit) between the
                    # wakeup and the sendall of the root graph
                    with self._lock:
                        self._waiters += 1
                    try:
                        with self._lock:
                            while key not in self._graphs and time.time() < deadline:
                                self._lock.wait(timeout=min(1.0, max(deadline - time.time(), 0.01)))
                            data = self._graphs.get(key, b"")
                        _send_msg(conn, {"len": len(data)}, data)
                    finally:
                        with self._lock:
                            self._waiters -= 1
                            self._lock.notify_all()
                else:
                    _send_msg(conn, {"error": f"unknown op {op!r}"})
        except (ConnectionError, OSError):
            pass

    def drain(self, timeout_s: float = 60.0) -> None:
        """Block process exit while peers are still waiting on published (or
        about to be published) keys."""
        deadline = time.time() + timeout_s
        with self._lock:
            while self._waiters > 0 and time.time() < deadline:
                self._lock.wait(timeout=0.25)

    def close(self) -> None:
        self._stop = True
        try:
            self._sock.close()
        except OSError:
            pass


class TcpMergeCheckpointer:
    """The `MergeCheckpointer` interface as a client of the coordination
    server.

    The first constructor to bind the URL's port becomes host 0 and serves;
    every other one connects. An optional local (disk) MergeCheckpointer is
    written through, for resume."""

    # once connected, transfers get a generous timeout: a root merge's
    # subgraph can be tens of MB of gzipped JSON over a link between hosts
    TRANSFER_TIMEOUT_S = 600.0

    # claims granted to workers of this process (multi-process tests read
    # it to show that the merge tree was split)
    CLAIMS_GRANTED = 0

    def __init__(self, url: str, local=None):
        if not url.startswith("tcp://"):
            raise ValueError(f"coordinate URL must be tcp://HOST:PORT, got {url!r}")
        host, _, port_s = url[len("tcp://") :].rpartition(":")
        self.host, self.port = host or "127.0.0.1", int(port_s)
        self.local = local
        self.server = None
        # per-worker claim token: a claim is idempotent for its own holder (a
        # claim retried after a dropped response must not deny itself)
        self._tok = uuid.uuid4().hex
        # a dead or vanished coordinator degrades to a solo build (claims
        # succeed locally, nothing is exchanged): coordination shares work
        # and is never needed for a correct graph; a worker that joins after
        # host 0 has finished and exited still completes on its own
        self._dead = False
        try:
            self.server = CoordinatorServer(self.host, self.port)
            log.info("hosting merge coordinator on %s:%d", self.host, self.port)
        except OSError:
            log.info("joining merge coordinator at %s:%d", self.host, self.port)

    @staticmethod
    def fingerprint(leaf_names) -> str:
        """The key of a clade: the file checkpointer's own."""
        from pangraph_tpu_torch.build.build import MergeCheckpointer

        return MergeCheckpointer.fingerprint(leaf_names)

    def _rpc(self, header: dict, payload: bytes = b"", timeout: float = None, max_wait: float = 30.0):
        """One short-lived connection per op. Connection attempts retry until
        `max_wait` seconds have passed (a deadline, so that a 2 s connect
        timeout to an unreachable host and an instant refusal behave alike):
        host 0 may still be building its guide tree when a faster peer first
        calls in."""
        last = None
        deadline = time.time() + max_wait
        while True:
            try:
                with socket.create_connection((self.host, self.port), timeout=2.0) as sock:
                    sock.settimeout(timeout if timeout is not None else self.TRANSFER_TIMEOUT_S)
                    _send_msg(sock, header, payload)
                    return _recv_msg(sock)
            except (ConnectionError, OSError) as e:
                last = e
                if time.time() >= deadline:
                    break
                time.sleep(0.3)
        raise ConnectionError(f"merge coordinator unreachable at {self.host}:{self.port}: {last}")

    def _gone(self, err) -> None:
        if not self._dead:
            self._dead = True
            log.warning("merge coordinator unreachable (%s): continuing as a solo build", err)

    def try_claim(self, leaf_names, stale_s: float = 3600.0) -> bool:
        if self._dead:
            return True
        try:
            header, _ = self._rpc(
                {"op": "claim", "key": self.fingerprint(leaf_names), "stale_s": stale_s, "tok": self._tok}
            )
        except ConnectionError as e:
            self._gone(e)
            return True
        if header["ok"]:
            TcpMergeCheckpointer.CLAIMS_GRANTED += 1
        return bool(header["ok"])

    def save(self, leaf_names, graph) -> None:
        if self.local is not None:
            self.local.save(leaf_names, graph)
        if self._dead:
            return
        buf = io.BytesIO()
        with gzip.GzipFile(fileobj=buf, mode="wb", compresslevel=1) as gz:
            gz.write(graph.to_json().encode())
        try:
            self._rpc({"op": "put", "key": self.fingerprint(leaf_names), "len": buf.tell()}, buf.getvalue())
        except ConnectionError as e:
            self._gone(e)

    @staticmethod
    def _from_payload(payload: bytes):
        from pangraph_tpu_torch.graph.graph import Pangraph

        with gzip.GzipFile(fileobj=io.BytesIO(payload), mode="rb") as gz:
            return Pangraph.from_json(gz.read().decode())

    def load(self, leaf_names):
        if self.local is not None:
            g = self.local.load(leaf_names)
            if g is not None:
                return g
        if self._dead:
            return None
        try:
            header, payload = self._rpc({"op": "get", "key": self.fingerprint(leaf_names)})
        except ConnectionError as e:
            self._gone(e)
            return None
        return self._from_payload(payload) if header["len"] else None

    def wait_for(self, leaf_names, poll_s: float = 0.25, timeout_s: float = None):
        """Raises TimeoutError if the merge never arrives, also when the
        coordinator itself vanishes mid-wait; the build then computes the
        merge locally. poll_s is unused (the server wakes the waiter); it
        keeps MergeCheckpointer's signature."""
        t = timeout_s if timeout_s is not None else 3600.0
        if self._dead:
            raise TimeoutError("merge coordinator is gone")
        try:
            header, payload = self._rpc(
                {"op": "wait", "key": self.fingerprint(leaf_names), "timeout_s": t},
                timeout=t + 10.0, max_wait=5.0,
            )
        except ConnectionError as e:
            self._gone(e)
            raise TimeoutError("merge coordinator is gone") from e
        if not header["len"]:
            raise TimeoutError(f"timed out waiting for merge ({len(leaf_names)} leaves) via coordinator")
        return self._from_payload(payload)
