"""Cross-process :class:`~repro_torch.telemetry.events.StepDelta` transport.

The fleet-merge substrate alone leaves the transport in-process:
``FleetAggregator.ingest`` only ever sees bytes handed to it by the same
Python process.  This module is the real boundary crossing — per-host
producers on one side, the launcher-side aggregator on the other — with
loss, reordering, and reconnection handled explicitly:

- :class:`DeltaServer` / :class:`DeltaClient`: a length-prefixed framed
  channel over TCP or a Unix-domain socket.  The client keeps every sent
  delta in a bounded resend buffer until the server acknowledges its
  ``(boot, seq)``; a dropped connection reconnects with backoff and
  replays the unacked tail in order.  Delivery is therefore
  **at-least-once and per-host FIFO** — exactly the contract
  :class:`~repro_torch.serve.FleetAggregator`'s per-incarnation ``(boot, seq)``
  watermark dedups safely (a replayed delta is dropped whole; a restarted
  host's new ``boot`` is accepted immediately).
- :class:`ShmRing`: a same-machine shared-memory SPSC ring fast path —
  one producer process pushes framed payloads, one consumer pops them,
  no syscalls per record and no serialization beyond the wire payload
  itself.  No acks: within one machine the ring is lossless while both
  ends are alive, and a full ring back-pressures the producer
  (``push`` returns False).

Framing (normative spec in ``docs/wire_format.md``): every socket frame is

    u32 LE body length | u8 frame type | body

with type ``DATA`` (1) carrying ``u64 boot | u64 seq | StepDelta payload``
and type ``ACK`` (2) carrying ``u64 boot | u64 seq``.  The ``(boot, seq)``
ride *outside* the (possibly compressed) delta payload so the server acks
without decoding and the client tracks resends without keeping decoded
objects alive.

The server acknowledges a DATA frame once it is enqueued in server-process
memory; ``drain_into`` hands queued payloads to the aggregator on the
caller's thread (the aggregator is not thread-safe and never touched by
socket threads).  An ack therefore means "durable as long as the
aggregator process lives" — if the aggregator process dies, its merged
windows die with the queue, so no stronger durability would be observable.
"""
from __future__ import annotations

import os
import queue
import socket
import struct
import threading
import time
import zlib
from collections import OrderedDict
from dataclasses import dataclass

from .events import StepDelta, WireFormatError

FRAME_DATA = 1
FRAME_ACK = 2

_FRAME_HEAD = struct.Struct("<IB")
_BOOT_SEQ = struct.Struct("<QQ")

#: Refuse frames larger than this (a corrupt length prefix must not make
#: the receiver allocate gigabytes).
MAX_FRAME_BYTES = 64 << 20


class TransportError(RuntimeError):
    """A transport-layer failure (bad frame, oversized frame, closed peer)."""


@dataclass(frozen=True)
class Endpoint:
    """A typed transport endpoint: ``tcp`` (host + port), ``unix`` (socket
    path), or ``shm`` (shared-memory segment name).

    This is the one wiring surface every transport role shares — host,
    aggregator, and root all express "where do I listen / whom do I dial"
    as an Endpoint instead of the historical stringly-typed address
    tuples.  :meth:`parse` accepts every form the old ``parse_address``
    did (``("host", port)`` tuples, ``"host:port"``, ``"unix:/path"``, a
    bare path containing ``/``) plus the explicit ``tcp:host:port`` and
    ``shm:name`` prefixes, and an Endpoint itself (idempotent), so string
    forms keep working everywhere they ever did.

    :meth:`listen` and :meth:`connect` are the factories the roles use
    uniformly: ``listen`` binds a :class:`DeltaServer` (tcp/unix) or
    creates a :class:`ShmRing` (shm); ``connect`` dials a
    :class:`DeltaClient` (tcp/unix) or attaches a :class:`RingSender`
    (shm).  ``str(endpoint)`` is the canonical advertisable form and
    round-trips through :meth:`parse`.
    """

    kind: str                  # "tcp" | "unix" | "shm"
    host: str = ""             # tcp only
    port: int = 0              # tcp only
    path: str = ""             # unix socket path or shm segment name

    _KINDS = ("tcp", "unix", "shm")

    def __post_init__(self) -> None:
        if self.kind not in self._KINDS:
            raise ValueError(f"unknown endpoint kind {self.kind!r}")

    @classmethod
    def parse(cls, value) -> "Endpoint":
        """Normalize any accepted address form into an Endpoint."""
        if isinstance(value, Endpoint):
            return value
        if isinstance(value, tuple) and len(value) == 2:
            host, port = value
            return cls("tcp", host=str(host), port=int(port))
        if isinstance(value, str) and value:
            if value.startswith("unix:"):
                return cls("unix", path=value[len("unix:"):])
            if value.startswith("shm:"):
                return cls("shm", path=value[len("shm:"):])
            if value.startswith("tcp:"):
                value = value[len("tcp:"):]
                if ":" not in value:
                    raise ValueError(f"tcp endpoint needs host:port, got {value!r}")
            if ":" in value and not value.startswith("/"):
                host, _, port = value.rpartition(":")
                return cls("tcp", host=host or "127.0.0.1", port=int(port))
            if "/" in value:
                return cls("unix", path=value)
        raise ValueError(f"unparseable transport address {value!r}")

    def __str__(self) -> str:
        if self.kind == "tcp":
            return f"{self.host}:{self.port}"
        return f"{self.kind}:{self.path}"

    # -- socket plumbing ----------------------------------------------------
    @property
    def family(self) -> int:
        if self.kind == "tcp":
            return socket.AF_INET
        if self.kind == "unix":
            return socket.AF_UNIX
        raise ValueError("shm endpoints have no socket family")

    @property
    def sockaddr(self):
        if self.kind == "tcp":
            return (self.host, self.port)
        if self.kind == "unix":
            return self.path
        raise ValueError("shm endpoints have no socket address")

    # -- role factories -----------------------------------------------------
    def listen(self, **kwargs):
        """Bind the listening side: a :class:`DeltaServer` for tcp/unix, a
        created :class:`ShmRing` for shm (kwargs pass through)."""
        if self.kind == "shm":
            return ShmRing.create(name=self.path or None, **kwargs)
        return DeltaServer(self, **kwargs)

    def connect(self, **kwargs):
        """Dial the producing side: a :class:`DeltaClient` for tcp/unix, a
        :class:`RingSender` over an attached :class:`ShmRing` for shm."""
        if self.kind == "shm":
            return RingSender(ShmRing.attach(self.path), **kwargs)
        return DeltaClient(self, **kwargs)


def parse_address(address) -> tuple[int, object]:
    """Normalize an address to ``(socket family, sockaddr)``.

    Back-compat shim over :meth:`Endpoint.parse`: ``("host", port)``
    tuples and ``"host:port"`` strings are TCP (``AF_INET``);
    ``"unix:/path"`` (or a bare path containing ``/``) is a Unix-domain
    socket (``AF_UNIX``).  ``shm:`` endpoints have no socket family and
    raise ``ValueError`` here — use :class:`Endpoint` directly.
    """
    ep = Endpoint.parse(address)
    return ep.family, ep.sockaddr


def _recv_exact(sock: socket.socket, count: int) -> bytes | None:
    """Read exactly ``count`` bytes, or None on clean EOF at a frame
    boundary; raises on mid-frame EOF."""
    chunks = []
    got = 0
    while got < count:
        chunk = sock.recv(min(count - got, 1 << 20))
        if not chunk:
            if got == 0:
                return None
            raise TransportError(
                f"peer closed mid-frame ({got}/{count} bytes)"
            )
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def _read_frame(sock: socket.socket) -> tuple[int, bytes] | None:
    head = _recv_exact(sock, _FRAME_HEAD.size)
    if head is None:
        return None
    length, ftype = _FRAME_HEAD.unpack(head)
    if length > MAX_FRAME_BYTES:
        raise TransportError(f"frame of {length} bytes exceeds MAX_FRAME_BYTES")
    body = _recv_exact(sock, length) if length else b""
    if body is None and length:
        raise TransportError("peer closed before frame body")
    return ftype, body or b""


def _send_frame(sock: socket.socket, ftype: int, body: bytes) -> None:
    sock.sendall(_FRAME_HEAD.pack(len(body), ftype) + body)


class DeltaServer:
    """Aggregator-side socket endpoint: accept host connections, queue
    their delta payloads, ack each ``(boot, seq)`` on enqueue.

    Socket work happens on background threads; the aggregator is only
    touched from whatever thread calls :meth:`drain_into` (one call per
    diagnosis tick is the intended cadence)::

        server = DeltaServer(("127.0.0.1", 0))     # port 0 = ephemeral
        addr = server.address                       # advertise to hosts
        ... each tick ...
        server.drain_into(aggregator)
        for cause in aggregator.step(): ...

    ``address`` accepts every form of :meth:`Endpoint.parse`.  A
    Unix-socket path is unlinked on :meth:`close`.

    Ack timing (``ack``): ``"enqueue"`` (default) acknowledges a DATA
    frame the moment it is queued in server-process memory — "durable as
    long as the aggregator process lives".  ``"drain"`` defers the ack
    until :meth:`drain_into` has *ingested* the payload, so an aggregator
    that journals on ingest upgrades the ack to "durable across my own
    restart" — the HA contract a tree aggregator gives its children
    (plain :meth:`drain` in this mode acks on pop, since the caller took
    ownership).  In drain mode acks are sent from the draining thread;
    the per-connection reader threads never write, so no send lock is
    needed in either mode.

    Fault injection (``fault``): an optional hook called once per
    received DATA frame with ``(boot, seq, payload)``, returning one of

    - ``"pass"`` — deliver normally (also the meaning of any unknown
      verdict, so a buggy hook degrades to a no-op);
    - ``"drop"`` — discard the frame *without acking* and sever the
      connection, modelling receiver-side loss: the client's resend
      contract replays the unacked tail on reconnect;
    - ``"dup"`` — enqueue the payload twice (one ack), modelling
      at-least-once duplication — the aggregator's ``(boot, seq)``
      watermark absorbs the copy;
    - ``"reorder"`` — hold the frame back and enqueue it *after* the
      next frame from the same connection, modelling a reordering
      channel.  Downstream needs
      :class:`~repro_torch.serve.fleet.FleetAggregator` ``reorder_window > 0``
      to reconstruct the gap, otherwise the late frame is (by contract)
      dropped as a duplicate.

    Every non-pass verdict is counted in ``faults_injected``.  The hook
    exists for tests and the anomaly scenario
    engine; production servers leave it None.
    """

    def __init__(self, address, *, backlog: int = 16,
                 ack: str = "enqueue", fault=None) -> None:
        if ack not in ("enqueue", "drain"):
            raise ValueError(f"unknown ack mode {ack!r}")
        self.ack_mode = ack
        self.fault = fault
        self.faults_injected = 0
        self.endpoint = Endpoint.parse(address)
        self.family = self.endpoint.family
        self._sock = socket.socket(self.family, socket.SOCK_STREAM)
        if self.family == socket.AF_INET:
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(self.endpoint.sockaddr)
        self._sock.listen(backlog)
        self.address = self._sock.getsockname()
        if self.endpoint.kind == "tcp":
            # Re-anchor on the *bound* port (port 0 = ephemeral).
            self.endpoint = Endpoint("tcp", host=self.address[0],
                                     port=self.address[1])
        # Items are (payload, ack) where ack is None (already acked at
        # enqueue) or a zero-arg callable sending the deferred ack.
        self._queue: queue.Queue[tuple[bytes, object]] = queue.Queue()
        self._closed = False
        self._conns: list[socket.socket] = []
        self._lock = threading.Lock()
        self.frames_received = 0
        self.bytes_received = 0
        self.connections_accepted = 0
        self.frame_errors = 0
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="DeltaServer.accept", daemon=True
        )
        self._accept_thread.start()

    # -- background threads ------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # closed
            with self._lock:
                if self._closed:
                    conn.close()
                    return
                self._conns.append(conn)
                self.connections_accepted += 1
            threading.Thread(
                target=self._conn_loop, args=(conn,),
                name="DeltaServer.conn", daemon=True,
            ).start()

    def _conn_loop(self, conn: socket.socket) -> None:
        # One reader thread per connection is the only writer of its acks,
        # so no send lock is needed here.
        held: list[tuple[int, int, bytes]] = []  # "reorder" fault holdback

        def enqueue(boot: int, seq: int, payload: bytes) -> None:
            if self.ack_mode == "enqueue":
                self._queue.put((payload, None))
                _send_frame(conn, FRAME_ACK, _BOOT_SEQ.pack(boot, seq))
            else:
                self._queue.put((payload, self._deferred_ack(conn, boot, seq)))
            self.frames_received += 1
            self.bytes_received += len(payload)

        try:
            while True:
                frame = _read_frame(conn)
                if frame is None:
                    return
                ftype, body = frame
                if ftype != FRAME_DATA or len(body) < _BOOT_SEQ.size:
                    self.frame_errors += 1
                    return  # protocol violation: drop the connection
                boot, seq = _BOOT_SEQ.unpack_from(body, 0)
                payload = body[_BOOT_SEQ.size:]
                verdict = (self.fault(boot, seq, payload)
                           if self.fault is not None else "pass")
                if verdict == "drop":
                    # Receiver-side loss: no enqueue, no ack — sever so
                    # the client replays the unacked tail on reconnect.
                    self.faults_injected += 1
                    return
                if verdict == "reorder":
                    self.faults_injected += 1
                    held.append((boot, seq, payload))
                    continue
                enqueue(boot, seq, payload)
                if verdict == "dup":
                    self.faults_injected += 1
                    self._queue.put((payload, None))
                while held:
                    enqueue(*held.pop(0))
        except (TransportError, OSError):
            self.frame_errors += 1
        finally:
            # A frame still held back when the connection dies is
            # enqueued anyway — holdback reorders, it must never lose.
            for boot, seq, payload in held:
                try:
                    enqueue(boot, seq, payload)
                except OSError:
                    self._queue.put((payload, None))
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)
            conn.close()

    # -- caller-thread surface ---------------------------------------------
    @staticmethod
    def _deferred_ack(conn: socket.socket, boot: int, seq: int):
        def send_ack() -> None:
            try:
                _send_frame(conn, FRAME_ACK, _BOOT_SEQ.pack(boot, seq))
            except OSError:
                pass  # dead connection: the client will resend on reconnect
        return send_ack

    @property
    def pending(self) -> int:
        return self._queue.qsize()

    def drain(self, max_payloads: int | None = None) -> list[bytes]:
        """Pop queued delta payloads (all of them by default).  In
        ``ack="drain"`` mode each popped payload is acked here — the
        caller took ownership; use :meth:`drain_into` to defer acks past
        ingest instead."""
        out: list[bytes] = []
        while max_payloads is None or len(out) < max_payloads:
            try:
                payload, ack = self._queue.get_nowait()
            except queue.Empty:
                break
            out.append(payload)
            if ack is not None:
                ack()
        return out

    def drain_into(self, aggregator, max_payloads: int | None = None) -> int:
        """Ingest every queued payload into ``aggregator`` (its
        ``(boot, seq)`` dedup makes replayed frames free).  A payload that
        fails wire validation is dropped and counted in ``frame_errors``
        rather than poisoning the tick (and still acked — it would be
        corrupt on every redelivery too).  In ``ack="drain"`` mode the ack
        goes out only after ``ingest`` returned, so an aggregator that
        journals inside ingest never acks a payload it could lose.
        Returns rows ingested."""
        rows = 0
        n = 0
        while max_payloads is None or n < max_payloads:
            try:
                payload, ack = self._queue.get_nowait()
            except queue.Empty:
                break
            n += 1
            try:
                rows += aggregator.ingest(payload)
            except WireFormatError:
                self.frame_errors += 1
            if ack is not None:
                ack()
        return rows

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            conns = list(self._conns)
        try:
            # Wake a thread blocked in accept(); close() alone does not on
            # every kernel, and a pinned accept keeps the port in LISTEN.
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        self._accept_thread.join(timeout=1.0)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            conn.close()
        if self.family == socket.AF_UNIX and isinstance(self.address, str):
            try:
                os.unlink(self.address)
            except OSError:
                pass

    def __enter__(self) -> "DeltaServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class DeltaClient:
    """Host-side socket endpoint with at-least-once resend.

    :meth:`send` serializes the delta (wire v2 by default), stamps its
    ``(boot, seq)`` on the frame, appends it to the unacked buffer, and
    transmits if connected.  A send on a dead connection buffers the frame
    and triggers a (rate-limited) reconnect attempt; on reconnect the
    whole unacked tail is replayed in order before new frames — the
    aggregator's per-incarnation seq watermark drops anything the server
    already saw.  ``flush()`` blocks until every buffered frame is acked
    (retrying connects) — call it before process exit so a crash-free run
    loses nothing.

    The buffer is bounded (``resend_cap`` frames): while the aggregator
    is unreachable beyond it, the *oldest* frames are shed and counted in
    ``resend_drops`` — live telemetry prefers losing the stale tail to
    growing without bound.  Socket sends are bounded too
    (``send_timeout``, via ``SO_SNDTIMEO`` so the ack reader's recv is
    untouched): an aggregator that stops draining fills the TCP window
    and the send fails over to the resend buffer instead of hanging the
    caller's step loop.

    ``clock`` (default ``time.monotonic``) is the timebase for reconnect
    rate-limiting and the ``flush`` deadline — inject a simulated clock
    (the anomaly scenario engine, tests) to run resend timing at
    simulated time; the default keeps wall-clock behavior byte-identical.
    ``fault`` is an optional sender-side hook called once per first
    transmission with ``(boot, seq, payload)``: ``"drop"`` buffers the
    frame but severs the connection instead of sending (the frame goes
    out with the reconnect replay — sender-side loss), ``"dup"``
    transmits the frame twice; anything else passes.  Replayed frames are
    never faulted, so every injected loss converges.  Non-pass verdicts
    count in ``faults_injected``.
    """

    def __init__(
        self,
        address,
        *,
        wire_version: int | None = None,
        resend_cap: int = 1024,
        connect_timeout: float = 5.0,
        retry_interval: float = 0.2,
        send_timeout: float = 5.0,
        clock=time.monotonic,
        fault=None,
    ) -> None:
        self.endpoint = Endpoint.parse(address)
        self.family, self.sockaddr = self.endpoint.family, self.endpoint.sockaddr
        # None = StepDelta.to_bytes auto-select: v2, upgraded to v3 only
        # when the delta carries attributed causes.
        self.wire_version = None if wire_version is None else int(wire_version)
        self.resend_cap = int(resend_cap)
        self.connect_timeout = float(connect_timeout)
        self.retry_interval = float(retry_interval)
        self.send_timeout = float(send_timeout)
        self.clock = clock
        self.fault = fault
        self.faults_injected = 0
        self._sock: socket.socket | None = None
        self._reader: threading.Thread | None = None
        self._gen = 0  # bumps per (re)connect so stale readers exit
        self._lock = threading.Lock()
        self._acked = threading.Condition(self._lock)
        self._unacked: OrderedDict[tuple[int, int], bytes] = OrderedDict()
        self._closed = False
        self._next_retry = 0.0
        self.frames_sent = 0
        self.bytes_sent = 0
        self.acks_received = 0
        self.reconnects = 0
        self.resend_drops = 0
        # (boot, seq) keys acked since the last take_acks() — how a tree
        # aggregator learns which forwarded envelopes its parent durably
        # accepted.  Bounded: nobody draining must not leak.
        self._ack_history: list[tuple[int, int]] = []

    # -- public surface ----------------------------------------------------
    @property
    def unacked(self) -> int:
        with self._lock:
            return len(self._unacked)

    def take_acks(self) -> list[tuple[int, int]]:
        """Drain the ``(boot, seq)`` keys acked since the last call, in
        ack order.  A tree aggregator polls this each tick to retire its
        forwarded envelopes from the journal."""
        with self._lock:
            out, self._ack_history = self._ack_history, []
        return out

    def send(self, delta: StepDelta) -> bool:
        """Buffer + transmit one delta; returns True if it went out on a
        live connection (False = buffered for resend)."""
        return self.send_bytes(
            delta.to_bytes(version=self.wire_version), delta.boot, delta.seq
        )

    def send_bytes(self, payload: bytes, boot: int, seq: int) -> bool:
        """Lower-level send for pre-serialized payloads; ``(boot, seq)``
        must match the payload's header (they key the ack)."""
        frame = _BOOT_SEQ.pack(boot, seq) + payload
        with self._lock:
            if self._closed:
                raise TransportError("DeltaClient is closed")
            self._unacked[(boot, seq)] = frame
            while len(self._unacked) > self.resend_cap:
                self._unacked.popitem(last=False)
                self.resend_drops += 1
            was_connected = self._sock is not None
            if not self._ensure_connected_locked():
                return False
            if not was_connected:
                # A fresh connection already replayed the whole buffer —
                # including this frame; sending it again here would just
                # burn a duplicate on the dedup watermark.
                return True
            verdict = (self.fault(boot, seq, payload)
                       if self.fault is not None else "pass")
            if verdict == "drop":
                # Sender-side loss: the frame stays buffered; severing
                # the link makes the resend contract deliver it with the
                # next reconnect replay.
                self.faults_injected += 1
                self._disconnect_locked()
                return False
            try:
                _send_frame(self._sock, FRAME_DATA, frame)
                self.frames_sent += 1
                self.bytes_sent += len(payload)
                if verdict == "dup":
                    self.faults_injected += 1
                    _send_frame(self._sock, FRAME_DATA, frame)
                    self.frames_sent += 1
                return True
            except OSError:
                self._disconnect_locked()
                return False

    def flush(self, timeout: float = 30.0) -> bool:
        """Block until every buffered frame is acked (reconnecting and
        replaying as needed).  Returns False on timeout."""
        deadline = self.clock() + timeout
        with self._lock:
            while self._unacked:
                if self.clock() >= deadline:
                    return False
                if self._sock is None:
                    self._next_retry = 0.0  # flush retries eagerly
                    if not self._ensure_connected_locked():
                        self._acked.wait(timeout=self.retry_interval)
                        continue
                self._acked.wait(timeout=0.05)
        return True

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._disconnect_locked()

    def __enter__(self) -> "DeltaClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- internals (all hold self._lock) -----------------------------------
    def _disconnect_locked(self) -> None:
        if self._sock is not None:
            try:
                # shutdown() before close(): the ack reader blocked in
                # recv on this fd pins the file description, so a bare
                # close() would defer the FIN until that recv returns —
                # the server would never learn the connection died (and
                # a reorder holdback flushed on connection death would
                # wait forever).
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        self._gen += 1  # orphan any reader still blocked on the old sock

    def _ensure_connected_locked(self) -> bool:
        if self._sock is not None:
            return True
        now = self.clock()
        if now < self._next_retry:
            return False
        self._next_retry = now + self.retry_interval
        sock = socket.socket(self.family, socket.SOCK_STREAM)
        sock.settimeout(self.connect_timeout)
        try:
            sock.connect(self.sockaddr)
        except OSError:
            sock.close()
            return False
        sock.settimeout(None)
        if self.send_timeout > 0:
            # Bound *sends* only (SO_SNDTIMEO, not settimeout — the ack
            # reader blocks in recv on this same socket and must not get
            # spurious timeouts): a stalled aggregator whose TCP window
            # filled turns into an OSError here, the frame stays in the
            # bounded resend buffer, and the caller's step loop keeps
            # moving instead of hanging inside send().
            try:
                sec = int(self.send_timeout)
                usec = int((self.send_timeout - sec) * 1e6)
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                                struct.pack("@ll", sec, usec))
            except OSError:  # pragma: no cover - platform without the opt
                pass
        self._sock = sock
        self._gen += 1
        gen = self._gen
        if self.frames_sent or self.acks_received:
            self.reconnects += 1
        # Replay the unacked tail in order on the fresh connection.
        try:
            for frame in self._unacked.values():
                _send_frame(sock, FRAME_DATA, frame)
                self.frames_sent += 1
                self.bytes_sent += len(frame) - _BOOT_SEQ.size
        except OSError:
            self._disconnect_locked()
            return False
        self._reader = threading.Thread(
            target=self._ack_loop, args=(sock, gen),
            name="DeltaClient.acks", daemon=True,
        )
        self._reader.start()
        return True

    def _ack_loop(self, sock: socket.socket, gen: int) -> None:
        try:
            while True:
                frame = _read_frame(sock)
                if frame is None:
                    break
                ftype, body = frame
                if ftype != FRAME_ACK or len(body) != _BOOT_SEQ.size:
                    break
                boot, seq = _BOOT_SEQ.unpack(body)
                with self._lock:
                    if gen != self._gen:
                        return  # superseded by a reconnect
                    # Cumulative prefix ack: the channel is FIFO and the
                    # server acks every DATA frame, so everything of this
                    # boot at or before ``seq`` in send order is
                    # delivered.  A duplicate ack (a replayed frame the
                    # server acked twice) matches nothing and is a no-op
                    # — it must never pop newer, still-unacked frames.
                    while self._unacked:
                        k = next(iter(self._unacked))
                        if k[0] != boot or k[1] > seq:
                            break
                        self._unacked.popitem(last=False)
                        self.acks_received += 1
                        self._ack_history.append(k)
                    del self._ack_history[: -4 * self.resend_cap or None]
                    self._acked.notify_all()
        except (TransportError, OSError):
            pass
        with self._lock:
            if gen == self._gen:
                self._disconnect_locked()
                self._acked.notify_all()


class ShmRing:
    """Same-machine SPSC shared-memory ring for framed delta payloads.

    One producer process :meth:`push`\\ es ``u32 length | u32 crc32 |
    payload`` records; one consumer :meth:`pop`\\ s them.  Head (read) and
    tail (write) are monotonically increasing u64 byte cursors at offsets
    0 and 8 of the segment; the data region is ``capacity`` bytes after
    the 24-byte header, addressed modulo capacity with byte-granular
    wrap.  A record's bytes are written before the tail cursor is
    published, and with exactly one writer and one reader no lock is
    needed.  Pure Python cannot issue memory fences, so on
    weakly-ordered CPUs a consumer may briefly observe the published
    tail before the record bytes land: the per-record CRC makes that
    safe — :meth:`pop` treats a mismatched record as *not yet visible*
    and returns None (the bytes settle within the store-buffer drain,
    microseconds), raising :class:`TransportError` only if the same
    record stays invalid for a full second of retries (real corruption,
    e.g. a second writer).  ``push`` on a full ring returns False
    (back-pressure, not blocking) — the producer decides whether to
    retry or shed.

    Use :meth:`create` on the owning side and :meth:`attach` (by name) in
    the peer process; the creator :meth:`close`\\ s with ``unlink=True``.
    The header also records the creator's PID so a *cross-process* attach
    can detach itself from Python's shared-memory resource tracker (which
    would otherwise unlink the live segment when the attaching process
    exits — fixed upstream only in 3.13's ``track=False``), while a
    same-process attach leaves tracking alone.
    """

    _HEADER = 32       # u64 head | u64 tail | u64 creator pid | u64 capacity
    _REC_HEAD = 8      # u32 payload length | u32 crc32(payload)
    #: Consecutive failed validations of the *same* head position before
    #: pop() declares the ring corrupt rather than awaiting visibility.
    _MAX_VISIBILITY_RETRIES = 10_000

    def __init__(self, shm, capacity: int, owner: bool) -> None:
        self._shm = shm
        self.capacity = capacity
        self.owner = owner
        self.pushes = 0
        self.pops = 0
        self.full_rejects = 0
        self.frame_errors = 0
        self._retries_at = (-1, 0)  # (head position, failed validations)

    # -- construction ------------------------------------------------------
    @classmethod
    def create(cls, capacity: int = 1 << 20, name: str | None = None) -> "ShmRing":
        from multiprocessing import shared_memory

        shm = shared_memory.SharedMemory(
            name=name, create=True, size=cls._HEADER + int(capacity)
        )
        shm.buf[: cls._HEADER] = bytes(cls._HEADER)  # head = tail = 0
        struct.pack_into("<QQ", shm.buf, 16, os.getpid(), int(capacity))
        return cls(shm, int(capacity), owner=True)

    @classmethod
    def attach(cls, name: str) -> "ShmRing":
        from multiprocessing import shared_memory

        shm = shared_memory.SharedMemory(name=name, create=False)
        creator_pid = struct.unpack_from("<Q", shm.buf, 16)[0]
        if creator_pid != os.getpid():
            try:  # Python <3.13: stop the resource tracker of an
                # *attaching* process from unlinking the live segment when
                # that process exits (the owner unlinks in close()).  A
                # same-process attach keeps its registration — the owner's
                # unlink pairs with it.
                from multiprocessing import resource_tracker

                resource_tracker.unregister(shm._name, "shared_memory")  # noqa: SLF001
            except Exception:  # pragma: no cover - tracker internals moved
                pass
        # The creator's requested capacity, from the header — NOT derived
        # from shm.size: platforms round segments up to page multiples,
        # and both ends must wrap modulo the same number.
        capacity = struct.unpack_from("<Q", shm.buf, 24)[0]
        if not 0 < capacity <= shm.size - cls._HEADER:
            raise TransportError(
                f"shm segment {name!r} header declares capacity {capacity} "
                f"outside the {shm.size}-byte segment — not a ShmRing?"
            )
        return cls(shm, int(capacity), owner=False)

    @property
    def name(self) -> str:
        return self._shm.name

    @property
    def endpoint(self) -> Endpoint:
        """This ring as a typed endpoint (``shm:<segment name>``) — the
        advertisable form a producer hands to :meth:`Endpoint.connect`."""
        return Endpoint("shm", path=self._shm.name)

    # -- cursors -----------------------------------------------------------
    def _head(self) -> int:
        return struct.unpack_from("<Q", self._shm.buf, 0)[0]

    def _tail(self) -> int:
        return struct.unpack_from("<Q", self._shm.buf, 8)[0]

    def _set_head(self, v: int) -> None:
        struct.pack_into("<Q", self._shm.buf, 0, v)

    def _set_tail(self, v: int) -> None:
        struct.pack_into("<Q", self._shm.buf, 8, v)

    def _write(self, pos: int, data: bytes) -> None:
        pos %= self.capacity
        first = min(len(data), self.capacity - pos)
        base = self._HEADER
        self._shm.buf[base + pos : base + pos + first] = data[:first]
        if first < len(data):
            self._shm.buf[base : base + len(data) - first] = data[first:]

    def _read(self, pos: int, count: int) -> bytes:
        pos %= self.capacity
        base = self._HEADER
        first = min(count, self.capacity - pos)
        out = bytes(self._shm.buf[base + pos : base + pos + first])
        if first < count:
            out += bytes(self._shm.buf[base : base + count - first])
        return out

    # -- SPSC operations ---------------------------------------------------
    def push(self, payload: bytes) -> bool:
        """Producer side: frame + write ``payload``; False if the ring
        lacks space (record never partially visible)."""
        need = self._REC_HEAD + len(payload)
        if need > self.capacity:
            raise ValueError(
                f"payload of {len(payload)} bytes exceeds ring capacity"
            )
        head, tail = self._head(), self._tail()
        if self.capacity - (tail - head) < need:
            self.full_rejects += 1
            return False
        self._write(tail, struct.pack("<II", len(payload),
                                      zlib.crc32(payload)))
        self._write(tail + self._REC_HEAD, payload)
        self._set_tail(tail + need)  # publish
        self.pushes += 1
        return True

    def _not_yet_visible(self, head: int) -> None:
        """A record that fails validation under a published tail is, on a
        healthy SPSC ring, a store still draining on a weakly-ordered
        CPU: back off and let the caller retry.  The same head position
        failing persistently is real corruption."""
        pos, n = self._retries_at
        n = n + 1 if pos == head else 1
        self._retries_at = (head, n)
        if n > self._MAX_VISIBILITY_RETRIES:
            raise TransportError(
                "shm ring corrupt: record at head failed validation "
                f"{n} times (length/crc never settled)"
            )

    def pop(self) -> bytes | None:
        """Consumer side: next payload; None if the ring is empty or the
        head record's bytes are not yet fully visible (retry later)."""
        head, tail = self._head(), self._tail()
        if tail == head:
            return None
        length, crc = struct.unpack("<II", self._read(head, self._REC_HEAD))
        if self._REC_HEAD + length > tail - head:
            self._not_yet_visible(head)
            return None
        payload = self._read(head + self._REC_HEAD, length)
        if zlib.crc32(payload) != crc:
            self._not_yet_visible(head)
            return None
        self._retries_at = (-1, 0)
        self._set_head(head + self._REC_HEAD + length)
        self.pops += 1
        return payload

    def drain_into(self, aggregator, max_payloads: int | None = None) -> int:
        """Consumer convenience: pop and ingest until empty.  A payload
        failing wire validation is dropped and counted in
        ``frame_errors`` rather than poisoning the tick (the socket
        server's ``drain_into`` contract)."""
        rows = 0
        n = 0
        while max_payloads is None or n < max_payloads:
            payload = self.pop()
            if payload is None:
                break
            try:
                rows += aggregator.ingest(payload)
            except WireFormatError:
                self.frame_errors += 1
            n += 1
        return rows

    def close(self, unlink: bool | None = None) -> None:
        if unlink is None:
            unlink = self.owner
        self._shm.close()
        if unlink:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass

    def __enter__(self) -> "ShmRing":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class RingSender:
    """Adapter giving :class:`ShmRing` the producer-side ``send(delta)``
    surface of :class:`DeltaClient` (so ``Diagnosis.forward(...)`` and
    the launcher treat socket and ring paths uniformly).  A full ring
    retries briefly, then sheds the delta (``shed`` counter) — the
    same-machine consumer draining each tick makes sustained fullness an
    aggregator stall, which telemetry must survive.  The retry wait is
    the only wall-clock dependence on the whole shm path (``ShmRing``
    itself spins on visibility retries, never on time) — inject
    ``sleep=`` to run it at simulated time."""

    def __init__(self, ring: ShmRing, *, wire_version: int | None = None,
                 retry: float = 0.01, sleep=time.sleep) -> None:
        self.ring = ring
        self.wire_version = None if wire_version is None else int(wire_version)
        self.retry = float(retry)
        self.sleep = sleep
        self.shed = 0

    def send(self, delta: StepDelta) -> bool:
        return self.send_bytes(
            delta.to_bytes(version=self.wire_version), delta.boot, delta.seq
        )

    def send_bytes(self, payload: bytes, boot: int, seq: int) -> bool:
        """Pre-serialized payload push (surface parity with
        :meth:`DeltaClient.send_bytes` so tree aggregators treat socket
        and ring parents uniformly).  ``(boot, seq)`` ride inside the
        payload; a successful push *is* the delivery — there is no ack
        channel, so consumers treating the return value as the ack get
        at-most-once on shed, exactly the ring's contract."""
        if self.ring.push(payload):
            return True
        self.sleep(self.retry)
        if self.ring.push(payload):
            return True
        self.shed += 1
        return False

    def flush(self, timeout: float = 0.0) -> bool:  # symmetry with DeltaClient
        return True

    def close(self) -> None:
        self.ring.close(unlink=False)
