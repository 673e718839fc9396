"""Socket WAL shipping: cross-host follower tails, no shared filesystem
(counterpart of ``quiver_tpu/fleet/walstream.py``).

``shipping.WALFollower`` assumes the follower can read the leader's
segment files.  This module removes that assumption: the leader runs a
:class:`WALStreamServer` — a TCP JSON-lines endpoint in the same
transport shape as the replica serving endpoint — and followers run a
:class:`WALStreamFollower`, the same
:class:`~quiver_tpu_torch.fleet.shipping.TailFollower` catch-up/holdback core
over a stream cursor instead of a byte cursor.

Wire protocol (one JSON object per line):

  * hello (client → server): ``{"from_lsn": N, "follower": id}`` — the
    resume cursor.  Reconnect-after-disconnect is just a new hello with
    the next uncommitted LSN; the server re-serves from there.
  * frame (server → client): ``{"lsn": N, "frame": "<base64>"}`` — the
    **raw disk bytes** of one ``blockio`` record (header + payload).
    The receiver runs ``blockio.scan_records`` over them, so the CRC
    that is re-verified is the one the leader's disk holds — a frame
    corrupted in server memory or on the wire is caught, ticked
    (``fleet_walstream_crc_errors_total``) and re-fetched by resume,
    never applied.  A checksum-corrupt slot on the leader's own disk
    ships as ``{"lsn": N, "kind": "corrupt"}`` (consumes its LSN,
    carries no op — identical to the file follower's treatment).
  * eot (server → client): ``{"eot": true, "next_lsn": N}`` — the
    leader's durable frontier; sent after every cycle as keepalive and
    staleness signal.  A torn tail on the leader's disk is *waited
    out* exactly like ``WALFollower`` does: the server stops before
    the torn frame and re-polls — it never ships unframeable bytes.
  * gap (server → client): ``{"error": "gap", ...}`` — the log no
    longer covers ``from_lsn`` (checkpoint truncation ran ahead of
    this follower); the follower resyncs from the newest shared
    checkpoint and reconnects, same contract as the file tail.

Chaos points ``fleet.walstream.send`` / ``fleet.walstream.recv`` fire
per shipped/received record, so a seeded plan can cut the stream at an
exact record index and the harness can prove resume-from-LSN loses
nothing.
"""

from __future__ import annotations

import base64
import json
import logging
import socket
import socketserver
import threading
import time
from typing import Callable, Optional, Tuple

from .. import telemetry
from ..recovery import blockio
from ..resilience import chaos
from ..resilience.errors import ChaosFault
from .shipping import TailFollower, list_segments, scan_frames

__all__ = ["WALStreamServer", "WALStreamFollower"]

log = logging.getLogger("quiver_tpu_torch.fleet")

_CHAOS_SEND = chaos.point("fleet.walstream.send")
_CHAOS_RECV = chaos.point("fleet.walstream.recv")


class _StreamReset(Exception):
    """Receiver-side transport anomaly (CRC mismatch, LSN gap, protocol
    garbage): drop the connection and resume from the committed LSN."""


class _RawTail:
    """Per-connection raw-frame cursor over the leader's segment files.

    The same walk as ``WALFollower.poll_once`` — reposition by LSN,
    stop at torn tails, rotate only past sealed segments — but yielding
    raw frame bytes instead of decoding them, and shipping corrupt
    slots as explicit markers.  Thread-private to one handler."""

    def __init__(self, wal_dir: str, next_lsn: int):
        self.wal_dir = str(wal_dir)
        self.next_lsn = int(next_lsn)
        self._seg_start: Optional[int] = None
        self._offset = 0

    def _reposition(self, segs) -> bool:
        candidates = [(s, p) for s, p in segs if s <= self.next_lsn]
        if not candidates:
            return False
        start, path = candidates[-1]
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return False
        frames, _torn = scan_frames(data)
        slot, offset = start, 0
        for _kind, _payload, _off, end in frames:
            if slot >= self.next_lsn:
                break
            slot += 1
            offset = end
        if slot < self.next_lsn:
            return False
        self._seg_start = start
        self._offset = offset
        return True

    def poll(self):
        """``("frames", [(lsn, kind, raw_bytes)])`` with whatever is
        newly visible (possibly empty), or ``("gap", oldest_lsn)`` when
        the log no longer covers the cursor."""
        segs = list_segments(self.wal_dir)
        if not segs:
            # an empty directory is a leader that has not appended yet
            # when the cursor is at the origin; anything else is a gap
            return (("frames", []) if self.next_lsn == 0
                    else ("gap", 0))
        if self._seg_start is None or not any(
                s == self._seg_start for s, _p in segs):
            if not self._reposition(segs):
                return ("gap", segs[0][0])
        out = []
        while True:
            seg_idx = next((i for i, (s, _p) in enumerate(segs)
                            if s == self._seg_start), None)
            if seg_idx is None:
                break
            _start, path = segs[seg_idx]
            try:
                with open(path, "rb") as f:
                    f.seek(self._offset)
                    chunk = f.read()
            except OSError:
                break
            frames, torn = scan_frames(chunk)
            for kind, _payload, off, end in frames:
                out.append((self.next_lsn, kind, bytes(chunk[off:end])))
                self.next_lsn += 1
            if frames:
                self._offset += frames[-1][3]
            if torn:
                break
            if seg_idx + 1 < len(segs):
                # sealed: rotate iff a successor exists
                self._seg_start = segs[seg_idx + 1][0]
                self._offset = 0
                continue
            break
        return ("frames", out)


class _StreamTCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class WALStreamServer:
    """Leader-side WAL stream endpoint: serve framed records from an
    LSN cursor to any number of followers.

    Read-only over the segment files (the WAL object keeps sole write
    ownership); an optional :class:`~quiver_tpu_torch.fleet.election.
    EpochFence` makes a deposed leader's stream go quiet — followers
    get a ``deposed`` error and re-resolve the write path through
    membership instead of tailing a fenced-off log."""

    def __init__(self, wal_dir: str, host: str = "127.0.0.1",
                 port: Optional[int] = None,
                 poll_interval_s: Optional[float] = None,
                 name: str = "leader", fence=None):
        from ..config import get_config

        cfg = get_config()
        self.wal_dir = str(wal_dir)
        self.host = host
        self.name = str(name)
        self.fence = fence
        self.poll_interval_s = float(
            poll_interval_s if poll_interval_s is not None
            else cfg.fleet_ship_poll_ms / 1e3)
        self._stop_evt = threading.Event()
        outer = self

        class _Handler(socketserver.StreamRequestHandler):
            def handle(self):
                outer._serve_conn(self)

        self._server = _StreamTCPServer(
            (host, int(port if port is not None
                       else cfg.fleet_walstream_port)), _Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name=f"quiver-fleet-walstream-{self.name}")
        self._thread.start()

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def stop(self, timeout: float = 5.0) -> None:
        from ..resilience.shutdown import join_and_reap

        self._stop_evt.set()
        self._server.shutdown()
        self._server.server_close()
        if self._thread.is_alive():
            join_and_reap([self._thread], timeout,
                          component="fleet.walstream")

    # -- one connection ------------------------------------------------
    def _serve_conn(self, handler) -> None:
        line = handler.rfile.readline()
        if not line:
            return
        try:
            hello = json.loads(line)
            from_lsn = int(hello.get("from_lsn", 0))
        except (ValueError, TypeError):
            self._send(handler, {"error": "bad_hello"})
            return
        telemetry.counter("fleet_walstream_connections_total",
                          replica=self.name).inc()
        if from_lsn > 0:
            telemetry.counter("fleet_walstream_resumes_total",
                              replica=self.name).inc()
        tail = _RawTail(self.wal_dir, from_lsn)
        try:
            while not self._stop_evt.is_set():
                if self.fence is not None and self.fence.deposed:
                    # a deposed leader must not keep feeding followers a
                    # log it no longer owns — send them back to
                    # membership to find the new write path
                    self._send(handler, {"error": "deposed"})
                    return
                state = tail.poll()
                if state[0] == "gap":
                    self._send(handler, {"error": "gap",
                                         "oldest_lsn": state[1]})
                    return
                for lsn, kind, raw in state[1]:
                    _CHAOS_SEND()
                    if kind == "ok":
                        msg = {"lsn": lsn,
                               "frame":
                               base64.b64encode(raw).decode("ascii")}
                    else:
                        msg = {"lsn": lsn, "kind": "corrupt"}
                    self._send(handler, msg)
                    telemetry.counter("fleet_walstream_sent_total",
                                      replica=self.name).inc()
                self._send(handler, {"eot": True,
                                     "next_lsn": tail.next_lsn})
                self._stop_evt.wait(self.poll_interval_s)
        except ChaosFault:
            # injected send fault: the connection dies mid-stream — the
            # follower's resume-from-LSN is what the harness proves
            return
        except OSError:
            return  # follower went away; its reconnect is a new hello

    @staticmethod
    def _send(handler, msg: dict) -> None:
        handler.wfile.write((json.dumps(msg) + "\n").encode())


class WALStreamFollower(TailFollower):
    """The socket-tail follower: :class:`TailFollower` holdback over a
    resumable stream cursor.

    ``endpoint_fn()`` returns the current ``(host, port)`` of the
    leader's stream endpoint (or None while there is no leader) — it is
    re-resolved on every (re)connect, so a fenced failover moves the
    tail to the new leader's endpoint without restarting the replica.
    """

    def __init__(self,
                 endpoint_fn: Callable[[], Optional[Tuple[str, int]]],
                 apply_fn: Callable[[int, str, object, object, object],
                                    None],
                 start_lsn: int = -1,
                 resync_fn: Optional[Callable[[], int]] = None,
                 poll_interval_s: Optional[float] = None,
                 grace_s: Optional[float] = None,
                 connect_timeout_s: Optional[float] = None,
                 name: str = "follower"):
        from ..config import get_config

        super().__init__(apply_fn, start_lsn=start_lsn,
                         resync_fn=resync_fn,
                         poll_interval_s=poll_interval_s, grace_s=grace_s,
                         name=name, thread_prefix="quiver-fleet-walstream")
        self.endpoint_fn = endpoint_fn
        self.connect_timeout_s = float(
            connect_timeout_s if connect_timeout_s is not None
            else get_config().fleet_request_timeout_s)
        # follower-thread-private stream cursor (same single-driver
        # contract as the file follower's byte cursor)
        self._sock: Optional[socket.socket] = None
        self._buf = bytearray()
        self._server_next: Optional[int] = None
        self._connected_once = False

    # -- transport -----------------------------------------------------
    def _disconnect(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        self._buf.clear()

    def _reset_cursor(self) -> None:
        self._disconnect()
        self._server_next = None

    def _close_transport(self) -> None:
        self._disconnect()

    def _connect(self) -> bool:
        ep = self.endpoint_fn()
        if not ep:
            return False
        try:
            sock = socket.create_connection(
                (ep[0], int(ep[1])), timeout=self.connect_timeout_s)
            sock.sendall((json.dumps(
                {"from_lsn": self._committed_next(),
                 "follower": self.name}) + "\n").encode())
        except OSError:
            return False
        self._sock = sock
        self._buf.clear()
        if self._connected_once:
            telemetry.counter("fleet_walstream_reconnects_total",
                              replica=self.name).inc()
        self._connected_once = True
        return True

    def _read_lines(self):
        """Complete lines until the poll deadline / eot — own buffering
        (a timeout mid-``readline`` on a makefile reader would leave
        its buffer state undefined; this never loses buffered bytes)."""
        deadline = time.monotonic() + max(self.poll_interval_s, 0.01)
        while True:
            nl = self._buf.find(b"\n")
            if nl >= 0:
                line = bytes(self._buf[:nl])
                del self._buf[:nl + 1]
                yield line
                continue
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            self._sock.settimeout(remaining)
            try:
                data = self._sock.recv(65536)
            except TimeoutError:
                return
            except socket.timeout:  # pre-3.10 alias, kept for safety
                return
            if not data:
                raise _StreamReset("stream closed by leader")
            self._buf += data

    def _verify(self, frame: bytes) -> bytes:
        """Receiver-side CRC re-verification of the shipped disk bytes,
        through the same ``blockio`` framing replay trusts."""
        scanned = list(blockio.scan_records(frame))
        if len(scanned) == 1 and scanned[0][0] == "ok":
            return scanned[0][2]
        telemetry.counter("fleet_walstream_crc_errors_total",
                          replica=self.name).inc()
        raise _StreamReset("frame failed CRC re-verification")

    # -- tailing -------------------------------------------------------
    def poll_once(self) -> int:
        if self._sock is None and not self._connect():
            self._publish_staleness()
            return 0
        committed = 0
        try:
            for line in self._read_lines():
                try:
                    msg = json.loads(line)
                except ValueError:
                    raise _StreamReset("unparsable stream line")
                if "error" in msg:
                    if msg["error"] == "gap":
                        # truncation ran ahead of us: same contract as
                        # the file tail — checkpoint resync
                        self._resync("stream gap (leader truncated)")
                        break
                    raise _StreamReset(f"stream error: {msg['error']}")
                if msg.get("eot"):
                    self._server_next = int(msg.get("next_lsn", -1))
                    break
                _CHAOS_RECV()
                lsn = int(msg["lsn"])
                vn = self._visible_next()
                if lsn < vn:
                    continue  # duplicate slot after a resume
                if lsn > vn:
                    raise _StreamReset(
                        f"stream skipped lsn {vn} (got {lsn})")
                payload = (None if msg.get("kind") == "corrupt"
                           else self._verify(
                               base64.b64decode(msg["frame"])))
                committed += self._observe(lsn, payload)
        except (_StreamReset, ChaosFault, OSError, KeyError,
                TypeError) as e:
            log.warning("walstream follower %s dropped connection: %s",
                        self.name, e)
            self._disconnect()
        committed += self._flush_held()
        self._publish_staleness()
        return committed

    def _extra_lag(self) -> int:
        if self._sock is None or self._server_next is None:
            return 0
        return max(self._server_next - self._visible_next(), 0)
