"""Step-scoped telemetry: turn one host's training/serving step into a
BigRoots :class:`TaskRecord`.

This is the "Spark log file" layer of the paper, adapted to SPMD training
(DESIGN.md §2): per step, each host times its local phases (data load, h2d,
compute-until-barrier, d2h, checkpoint), accumulates byte counters and GC
pauses, and emits a TaskRecord whose stage is the step window.  The
*pre-barrier duration* (host-local work) is the task duration — the honest
analog of a Spark task's runtime under a synchronous collective.

Fleet wire format
-----------------
Cross-node comparison is the whole BigRoots premise, so per-host telemetry
must reach a central aggregator.  :class:`StepDelta` is the unit shipped:
the columnar block of rows a host emitted since its last drain, grouped by
stage.  Two self-describing wire encodings exist (dispatched on the 4-byte
magic; ``docs/wire_format.md`` is the normative spec):

- **v1** (``BRD1``): one small JSON header (strings: host, stage ids, task
  ids, node names, column names) followed by raw little-endian numeric
  buffers — no pickling, no per-row framing, and a decode that is a
  handful of ``np.frombuffer`` views.
- **v2** (``BRD2``, the :meth:`StepDelta.to_bytes` default): the same
  header and column order, but every numeric column is delta-compressed —
  XOR against the previous row, a packed changed-row bitmask, byte-plane
  transposed residuals — and the whole body is DEFLATE-compressed.  A
  host's hot columns are near-constant step to step (constant batch
  bytes, quantized /proc counters, zero GC pauses), so most columns
  collapse to a bitmask.  The encoding is stateless per payload: a
  resent or reordered delta decodes without any reference state.
- **v3** (``BRD3``): v2's exact body layout plus an *attribution block*
  — the JSON header gains a ``causes`` list of wire-form attributed
  :class:`~repro_torch.core.analyzer.RootCause` records (see
  :func:`repro_torch.core.analyzer.cause_to_wire`), so a leaf or mid-tier
  diagnosis can ship its what-if priced causes upstream and have them
  survive fan-in tree aggregation byte-identically (``BRDF`` forwards
  inner payloads verbatim).  v3 is emitted *only when a delta actually
  carries causes*: with attribution off :meth:`StepDelta.to_bytes`
  produces v2 bytes unchanged, so v2-only readers never see a ``BRD3``
  frame from an unattributed fleet.

A per-column ``present`` mask rides along in both versions so "recorded
as 0.0" and "absent" stay distinct across the wire (the same invariant
the columnar substrate keeps in memory).  :meth:`StepDelta.from_bytes`
parses both versions, validating every header-declared length against the
actual buffer before touching numpy — a truncated or corrupt frame raises
:class:`WireFormatError`, never a reshape error deep in merge.
``StepTelemetry(wire=True)`` accumulates pending rows and
:meth:`StepTelemetry.drain_delta` cuts a delta; the launcher-side consumer
is :class:`repro_torch.serve.FleetAggregator`, and
:mod:`repro_torch.telemetry.transport` carries payloads across processes.
"""
from __future__ import annotations

import gc
import json
import struct
import time
import zlib
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np

from ..core.features import JAX_FEATURES, FeatureSchema
from ..core.frame import TraceStore
from ..core.window import SlidingStageWindow, StreamingTraceStore
from .timeline import ResourceTimeline

WIRE_V1_MAGIC = b"BRD1"
WIRE_V2_MAGIC = b"BRD2"
WIRE_V3_MAGIC = b"BRD3"
WIRE_FWD_MAGIC = b"BRDF"
_WIRE_MAGIC = WIRE_V1_MAGIC  # back-compat alias

#: Refuse headers claiming more than this many rows in one stage block —
#: far above any real drain, and it bounds what a corrupt length field can
#: make the decoder allocate.
_MAX_ROWS_PER_STAGE = 1 << 24

#: Refuse v2 frames declaring a decompressed body beyond this: the
#: declared length caps decompression *before* it runs, so a small
#: high-ratio DEFLATE bomb cannot make the decoder materialize gigabytes.
_MAX_BODY_BYTES = 1 << 30

#: Refuse v3 headers carrying more than this many attributed causes —
#: far above any real diagnosis tick, bounding allocation from a corrupt
#: or hostile header.
_MAX_WIRE_CAUSES = 1 << 16


class WireFormatError(ValueError):
    """A wire payload failed structural validation: bad magic, truncated
    or over-long buffers vs the header-declared lengths, a malformed JSON
    header, or a corrupt compression stream.  Subclasses ``ValueError``
    so pre-existing ``except ValueError`` callers keep working."""


def _need(buf_len: int, off: int, count: int, what: str) -> None:
    if count < 0 or off + count > buf_len:
        raise WireFormatError(
            f"truncated StepDelta payload: {what} needs {count} bytes at "
            f"offset {off} but only {buf_len - off} remain"
        )


# -- v2 column codecs --------------------------------------------------------
# Each numeric column is encoded as: XOR of every row against the previous
# row (first row against 0), a packed bitmask of rows whose XOR is nonzero,
# a u32 count of those rows, then the changed rows' XOR words transposed
# into byte planes (all byte-0s, then all byte-1s, ...).  Near-constant
# columns collapse to the bitmask; for varying columns the transpose groups
# the shared sign/exponent bytes into runs the final DEFLATE pass removes.
# Decode is exact: scatter residuals, prefix-XOR, reinterpret — bit
# identical to the raw column, NaNs and signed zeros included.

def _delta_encode(words: np.ndarray) -> bytes:
    """``words``: little-endian unsigned view of one column (u64/u16)."""
    n = words.size
    x = words.copy()
    x[1:] ^= words[:-1]
    changed = x != 0
    k = int(changed.sum())
    resid = np.ascontiguousarray(x[changed]).view(np.uint8)
    planes = resid.reshape(k, words.dtype.itemsize).T if k else resid
    return (np.packbits(changed).tobytes() + struct.pack("<I", k)
            + np.ascontiguousarray(planes).tobytes())


def _delta_decode(buf: bytes, off: int, n: int, dtype: str,
                  what: str) -> tuple[np.ndarray, int]:
    """Inverse of :func:`_delta_encode`; returns (column, new offset)."""
    itemsize = np.dtype(dtype).itemsize
    nmask = (n + 7) // 8
    _need(len(buf), off, nmask + 4, f"{what} changed-mask")
    changed = np.unpackbits(
        np.frombuffer(buf, np.uint8, nmask, off), count=n
    ).astype(bool)
    off += nmask
    (k,) = struct.unpack_from("<I", buf, off)
    off += 4
    if k != int(changed.sum()):
        raise WireFormatError(
            f"corrupt {what}: {k} residuals declared but the changed-mask "
            f"has {int(changed.sum())} set bits"
        )
    _need(len(buf), off, k * itemsize, f"{what} residuals")
    planes = np.frombuffer(buf, np.uint8, k * itemsize, off)
    off += k * itemsize
    x = np.zeros(n, dtype=dtype)
    if k:
        x[changed] = np.ascontiguousarray(
            planes.reshape(itemsize, k).T
        ).view(dtype).ravel()
    return np.bitwise_xor.accumulate(x), off


class GcTimer:
    """Accumulates Python GC pause time via gc callbacks (the 'JVM GC time'
    analog for a Python-driven input pipeline)."""

    def __init__(self, clock=time.perf_counter) -> None:
        self._clock = clock
        self._start: float | None = None
        self.total = 0.0
        self._installed = False

    def _cb(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._start = self._clock()
        elif phase == "stop" and self._start is not None:
            self.total += self._clock() - self._start
            self._start = None

    def install(self) -> "GcTimer":
        if not self._installed:
            gc.callbacks.append(self._cb)
            self._installed = True
        return self

    def uninstall(self) -> None:
        if self._installed:
            gc.callbacks.remove(self._cb)
            self._installed = False

    def take(self) -> float:
        """Return accumulated pause time and reset."""
        t, self.total = self.total, 0.0
        return t

    def __enter__(self) -> "GcTimer":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


@dataclass
class StageDelta:
    """One stage's slice of a :class:`StepDelta`: parallel columns for the
    rows a host added to that stage since the last drain."""

    stage_id: str
    task_ids: list[str]
    nodes: list[str]
    starts: np.ndarray          # float64 [m]
    ends: np.ndarray            # float64 [m]
    locality: np.ndarray        # int16   [m]
    columns: dict[str, np.ndarray]   # float64 [m] per feature name
    present: dict[str, np.ndarray]   # bool    [m] per feature name

    def __len__(self) -> int:
        return len(self.task_ids)


@dataclass
class StepDelta:
    """A host's telemetry rows since its last drain, as columnar blocks per
    stage — the unit a sharded fleet ships to the launcher-side
    :class:`~repro_torch.serve.FleetAggregator` (see module docstring for the
    wire layout).

    ``seq`` increases by one per drain within a producer incarnation;
    ``boot`` identifies the incarnation itself (a nanosecond timestamp
    taken when the :class:`StepTelemetry` was created).  Together they let
    the consumer tell a *redelivered* delta (same boot, seq not newer →
    drop) from a *restarted host* (newer boot → accept and reset) without
    any handshake.

    ``causes`` carries attributed root causes in wire form (dicts from
    :func:`repro_torch.core.analyzer.cause_to_wire`) for the v3 attribution
    block; it is empty on every v1/v2 payload and on any delta cut by
    an attribution-off pipeline."""

    host: str
    seq: int
    stages: list[StageDelta]
    boot: int = 0
    causes: list = field(default_factory=list)

    @property
    def num_rows(self) -> int:
        return sum(len(s) for s in self.stages)

    def apply_to(self, store: StreamingTraceStore) -> int:
        """Ingest every stage block into ``store`` (columnar bulk path,
        present masks preserved).  Returns rows ingested (late rows behind
        a window's watermark are dropped by the window, as ever)."""
        ingested = 0
        for s in self.stages:
            ingested += store.add_rows(
                s.stage_id, s.task_ids, s.nodes, s.starts, s.ends,
                s.locality, feature_columns=s.columns,
                present_columns=s.present,
            )
        return ingested

    # -- wire format -------------------------------------------------------
    def _header_bytes(self, *, with_causes: bool = False) -> bytes:
        header = {
            "host": self.host,
            "seq": self.seq,
            "boot": self.boot,
            "stages": [
                {
                    "stage_id": s.stage_id,
                    "n": len(s),
                    "task_ids": s.task_ids,
                    "nodes": s.nodes,
                    "columns": list(s.columns),
                }
                for s in self.stages
            ],
        }
        if with_causes:
            header["causes"] = list(self.causes)
        return json.dumps(header, separators=(",", ":")).encode()

    def _canonical_column(self, s: "StageDelta", name: str) -> np.ndarray:
        """Column values with masked-out slots forced to 0.0: whatever the
        producer left in the buffer, the wire carries the canonical form
        (the decoder re-imposes the mask either way)."""
        vals = np.asarray(s.columns[name], dtype="<f8")
        mask = s.present.get(name)
        if mask is not None:
            vals = np.where(np.asarray(mask, dtype=bool), vals, 0.0)
        return np.ascontiguousarray(vals, dtype="<f8")

    def _present_column(self, s: "StageDelta", name: str) -> np.ndarray:
        return np.ascontiguousarray(
            s.present.get(name, np.ones(len(s), dtype=bool)), dtype="u1"
        )

    def to_bytes(self, version: int | None = None) -> bytes:
        """Serialize this delta as a self-contained wire payload.

        ``version=None`` (default) auto-selects: version 2 normally,
        upgraded to version 3 iff ``causes`` is non-empty — so an
        attribution-off pipeline emits v2 bytes unchanged, byte for byte.
        ``version=3``: magic ``BRD3``, otherwise identical framing to v2
        (u32 decompressed body length, DEFLATE stream of [u32 header
        length, JSON header, per-stage delta-compressed column sections])
        except the JSON header carries a ``causes`` list of wire-form
        attributed root causes.  ``version=2``: magic ``BRD2``, same
        framing, no causes (requesting it with causes attached raises
        ``ValueError`` — the attribution block cannot be silently
        dropped).  ``version=1``: magic ``BRD1``, u32 header length,
        JSON header, then per stage the raw ``<f8/<i2/u1`` column
        buffers in header order.  All versions are stateless per payload
        and decoded by :meth:`from_bytes` off the magic alone (the
        deflate body is validated against its declared length).  Column
        values where ``present`` is False are encoded as 0.0 (the
        decoder re-imposes the mask)."""
        if version is None:
            version = 3 if self.causes else 2
        if version in (1, 2) and self.causes:
            raise ValueError(
                f"StepDelta carries {len(self.causes)} attributed causes; "
                f"wire version {version} cannot encode them (use version 3 "
                "or leave version unset)"
            )
        if version == 1:
            head = self._header_bytes()
            parts = [WIRE_V1_MAGIC, struct.pack("<I", len(head)), head]
            for s in self.stages:
                parts.append(np.ascontiguousarray(s.starts, dtype="<f8").tobytes())
                parts.append(np.ascontiguousarray(s.ends, dtype="<f8").tobytes())
                parts.append(np.ascontiguousarray(s.locality, dtype="<i2").tobytes())
                for name in s.columns:
                    parts.append(self._canonical_column(s, name).tobytes())
                    parts.append(self._present_column(s, name).tobytes())
            return b"".join(parts)
        if version not in (2, 3):
            raise ValueError(f"unknown StepDelta wire version {version!r}")
        head = self._header_bytes(with_causes=(version == 3))
        parts = [struct.pack("<I", len(head)), head]
        for s in self.stages:
            for col in (np.ascontiguousarray(s.starts, dtype="<f8"),
                        np.ascontiguousarray(s.ends, dtype="<f8")):
                parts.append(_delta_encode(col.view("<u8")))
            loc = np.ascontiguousarray(s.locality, dtype="<i2")
            parts.append(_delta_encode(loc.view("<u2")))
            for name in s.columns:
                parts.append(
                    _delta_encode(self._canonical_column(s, name).view("<u8"))
                )
                parts.append(np.packbits(
                    self._present_column(s, name).astype(bool)
                ).tobytes())
        body = b"".join(parts)
        magic = WIRE_V3_MAGIC if version == 3 else WIRE_V2_MAGIC
        return (magic + struct.pack("<I", len(body))
                + zlib.compress(body, 6))

    @staticmethod
    def wire_version(buf: bytes) -> int:
        """The wire version a payload's magic declares (without decoding);
        raises :class:`WireFormatError` on an unknown magic."""
        magic = bytes(buf[:4])
        if magic == WIRE_V1_MAGIC:
            return 1
        if magic == WIRE_V2_MAGIC:
            return 2
        if magic == WIRE_V3_MAGIC:
            return 3
        raise WireFormatError(
            f"not a StepDelta wire buffer (bad magic {magic!r})"
        )

    @staticmethod
    def _validated_header(head: bytes, version: int = 2) -> dict:
        try:
            header = json.loads(head.decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise WireFormatError(f"corrupt StepDelta header: {e}") from e
        if not isinstance(header, dict) or not isinstance(
            header.get("stages"), list
        ):
            raise WireFormatError("StepDelta header is not an object with stages")
        try:
            if not isinstance(header["host"], str):
                raise TypeError("host is not a string")
            int(header["seq"])
            int(header.get("boot", 0))
        except (KeyError, TypeError, ValueError) as e:
            raise WireFormatError(
                f"StepDelta header missing/malformed host/seq/boot: {e}"
            ) from e
        if version == 3:
            causes = header.get("causes", [])
            if not isinstance(causes, list) or not all(
                isinstance(c, dict) for c in causes
            ):
                raise WireFormatError(
                    "StepDelta v3 causes is not a list of objects"
                )
            if len(causes) > _MAX_WIRE_CAUSES:
                raise WireFormatError(
                    f"implausible attributed-cause count {len(causes)}"
                )
        elif "causes" in header:
            raise WireFormatError(
                f"StepDelta v{version} header carries a causes key "
                "(attribution requires wire version 3)"
            )
        for sh in header["stages"]:
            if not isinstance(sh, dict):
                raise WireFormatError("StepDelta stage header is not an object")
            try:
                if not isinstance(sh["stage_id"], str):
                    raise TypeError("stage_id is not a string")
                n = int(sh["n"])
                task_ids, nodes = sh["task_ids"], sh["nodes"]
                columns = sh["columns"]
                if not isinstance(task_ids, list) or not isinstance(nodes, list):
                    raise TypeError("task_ids/nodes are not lists")
                if not isinstance(columns, list) or not all(
                    isinstance(c, str) for c in columns
                ):
                    raise TypeError("columns is not a list of strings")
            except (KeyError, TypeError, ValueError) as e:
                raise WireFormatError(f"malformed stage header: {e}") from e
            if not 0 <= n <= _MAX_ROWS_PER_STAGE:
                raise WireFormatError(f"implausible stage row count {n}")
            if len(task_ids) != n or len(nodes) != n:
                raise WireFormatError(
                    f"stage {sh['stage_id']!r} declares n={n} but has "
                    f"{len(task_ids)} task_ids / {len(nodes)} nodes"
                )
        return header

    @classmethod
    def from_bytes(cls, buf: bytes) -> "StepDelta":
        """Decode a v1, v2, or v3 payload (dispatched on the magic).
        Every header-declared length is validated against the actual
        remaining bytes before any buffer view is taken; a truncated,
        over-long, or corrupt frame raises :class:`WireFormatError`.
        A v3 payload additionally yields the header's attribution block
        as ``causes`` (wire-form dicts, verbatim)."""
        buf = bytes(buf)
        if len(buf) < 8:
            raise WireFormatError(
                f"StepDelta payload too short ({len(buf)} bytes)"
            )
        version = cls.wire_version(buf)
        (length,) = struct.unpack_from("<I", buf, 4)
        if version >= 2:
            if length > _MAX_BODY_BYTES:
                raise WireFormatError(
                    f"StepDelta v{version} declares an implausible "
                    f"{length}-byte body"
                )
            try:
                z = zlib.decompressobj()
                # max_length caps allocation at the declared size *before*
                # inflating: a lying header cannot decompress-bomb us.
                body = z.decompress(buf[8:], length + 1)
            except zlib.error as e:
                raise WireFormatError(
                    f"corrupt StepDelta v{version} compression stream: {e}"
                ) from e
            if len(body) != length:
                raise WireFormatError(
                    f"StepDelta v{version} body is {len(body)}+ bytes but "
                    f"the frame declares {length}"
                )
            if not z.eof or z.unused_data:
                raise WireFormatError(
                    f"StepDelta v{version} compression stream is truncated "
                    "or has trailing bytes"
                )
            _need(len(body), 0, 4, "v2 header length")
            (hlen,) = struct.unpack_from("<I", body, 0)
            _need(len(body), 4, hlen, "v2 header")
            header = cls._validated_header(body[4 : 4 + hlen], version)
            off = 4 + hlen
            stages = []
            for sh in header["stages"]:
                n = int(sh["n"])
                sid = sh["stage_id"]
                starts, off = _delta_decode(body, off, n, "<u8",
                                            f"stage {sid!r} starts")
                ends, off = _delta_decode(body, off, n, "<u8",
                                          f"stage {sid!r} ends")
                loc, off = _delta_decode(body, off, n, "<u2",
                                         f"stage {sid!r} locality")
                columns: dict[str, np.ndarray] = {}
                present: dict[str, np.ndarray] = {}
                nmask = (n + 7) // 8
                for name in sh["columns"]:
                    what = f"stage {sid!r} column {name!r}"
                    col, off = _delta_decode(body, off, n, "<u8", what)
                    columns[name] = col.view("<f8").astype(np.float64)
                    _need(len(body), off, nmask, f"{what} present mask")
                    present[name] = np.unpackbits(
                        np.frombuffer(body, np.uint8, nmask, off), count=n
                    ).astype(bool)
                    off += nmask
                stages.append(StageDelta(
                    sid, list(sh["task_ids"]), list(sh["nodes"]),
                    starts.view("<f8").astype(np.float64),
                    ends.view("<f8").astype(np.float64),
                    loc.view("<i2").astype(np.int16),
                    columns, present,
                ))
            if off != len(body):
                raise WireFormatError(
                    f"StepDelta v{version} body has "
                    f"{len(body) - off} trailing bytes"
                )
            return cls(header["host"], int(header["seq"]), stages,
                       boot=int(header.get("boot", 0)),
                       causes=list(header.get("causes", [])))

        hlen = length
        _need(len(buf), 8, hlen, "v1 header")
        header = cls._validated_header(buf[8 : 8 + hlen], version)
        off = 8 + hlen
        stages = []
        for sh in header["stages"]:
            n = int(sh["n"])
            sid = sh["stage_id"]

            def take(dtype, what):
                nonlocal off
                itemsize = np.dtype(dtype).itemsize
                _need(len(buf), off, n * itemsize,
                      f"stage {sid!r} {what}")
                arr = np.frombuffer(buf, dtype=dtype, count=n, offset=off)
                off += arr.nbytes
                return arr

            starts = take("<f8", "starts").astype(np.float64)
            ends = take("<f8", "ends").astype(np.float64)
            locality = take("<i2", "locality").astype(np.int16)
            columns = {}
            present = {}
            for name in sh["columns"]:
                columns[name] = take("<f8", f"column {name!r}").astype(np.float64)
                present[name] = take("u1", f"column {name!r} mask").astype(bool)
            stages.append(StageDelta(
                sid, list(sh["task_ids"]), list(sh["nodes"]),
                starts, ends, locality, columns, present,
            ))
        if off != len(buf):
            raise WireFormatError(
                f"StepDelta v1 payload has {len(buf) - off} trailing bytes"
            )
        return cls(header["host"], int(header["seq"]), stages,
                   boot=int(header.get("boot", 0)))


#: Inner payload count cap per forwarded envelope — far above any real
#: forward batch, and it bounds what a corrupt header can allocate.
_MAX_FWD_PAYLOADS = 1 << 16

#: Envelope-in-envelope nesting a consumer will unwrap before declaring
#: the frame hostile.  A well-formed tree re-wraps at each hop (inner
#: payloads are always leaf StepDeltas), so real depth is 1; the cap only
#: bounds adversarial recursion.
MAX_FORWARD_DEPTH = 8


@dataclass
class ForwardedDelta:
    """A tree aggregator's pre-merged forwarded frame (wire magic
    ``BRDF``): the envelope around the inner :class:`StepDelta` payloads
    it accepted from its sub-fleet since its last forward.

    The envelope is *re-stamped* with the aggregator's own identity —
    ``host`` is the aggregator's fleet-unique name, ``(boot, seq)`` its
    incarnation stamp and per-forward counter — so the upstream
    consumer's ``(boot, seq)`` watermark dedups envelope redelivery
    exactly as it dedups host deltas.  The inner payloads ride through
    **verbatim** (the bytes the aggregator itself ingested, each keeping
    its original producer stamp): the root therefore dedups at *both*
    granularities, and a failed-over aggregator that re-forwards payloads
    an earlier incarnation already delivered produces only inner-level
    duplicate drops, never duplicate rows.  That per-payload exactness is
    what makes depth-2 aggregation byte-identical to the star topology.

    Wire layout (normative spec in ``docs/wire_format.md``)::

        "BRDF" | u32 header length | JSON header | inner payloads, concatenated

    with header ``{host, boot, seq, sizes: [len, ...]}``; every declared
    size is validated against the remaining bytes before any slice is
    taken, so a truncated or lying frame raises :class:`WireFormatError`.
    """

    host: str
    seq: int
    payloads: list[bytes]
    boot: int = 0

    @staticmethod
    def is_forwarded(buf) -> bool:
        """Cheap magic check (no decoding)."""
        return bytes(buf[:4]) == WIRE_FWD_MAGIC

    def to_bytes(self) -> bytes:
        head = json.dumps(
            {"host": self.host, "seq": self.seq, "boot": self.boot,
             "sizes": [len(p) for p in self.payloads]},
            separators=(",", ":"),
        ).encode()
        return b"".join(
            [WIRE_FWD_MAGIC, struct.pack("<I", len(head)), head,
             *map(bytes, self.payloads)]
        )

    @classmethod
    def from_bytes(cls, buf) -> "ForwardedDelta":
        buf = bytes(buf)
        if len(buf) < 8 or buf[:4] != WIRE_FWD_MAGIC:
            raise WireFormatError(
                f"not a ForwardedDelta wire buffer (magic {bytes(buf[:4])!r})"
            )
        (hlen,) = struct.unpack_from("<I", buf, 4)
        _need(len(buf), 8, hlen, "forwarded header")
        try:
            header = json.loads(buf[8 : 8 + hlen].decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise WireFormatError(f"corrupt ForwardedDelta header: {e}") from e
        try:
            host = header["host"]
            if not isinstance(host, str):
                raise TypeError("host is not a string")
            seq = int(header["seq"])
            boot = int(header.get("boot", 0))
            sizes = header["sizes"]
            if not isinstance(sizes, list) or not all(
                isinstance(s, int) and s >= 0 for s in sizes
            ):
                raise TypeError("sizes is not a list of non-negative ints")
        except (KeyError, TypeError, ValueError) as e:
            raise WireFormatError(
                f"ForwardedDelta header missing/malformed fields: {e}"
            ) from e
        if len(sizes) > _MAX_FWD_PAYLOADS:
            raise WireFormatError(
                f"implausible forwarded payload count {len(sizes)}"
            )
        off = 8 + hlen
        payloads: list[bytes] = []
        for i, size in enumerate(sizes):
            _need(len(buf), off, size, f"forwarded payload {i}")
            payloads.append(buf[off : off + size])
            off += size
        if off != len(buf):
            raise WireFormatError(
                f"ForwardedDelta frame has {len(buf) - off} trailing bytes"
            )
        return cls(host, seq, payloads, boot=boot)


@dataclass
class StepScope:
    """Mutable accumulator for one step on one host."""

    node: str
    step: int
    start: float
    clock: object
    phases: dict[str, float] = field(default_factory=dict)
    counters: dict[str, float] = field(default_factory=dict)
    locality: int = 0
    end: float | None = None

    @contextmanager
    def phase(self, name: str):
        t0 = self.clock()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + (self.clock() - t0)

    def add(self, counter: str, value: float) -> None:
        self.counters[counter] = self.counters.get(counter, 0.0) + value

    def set_locality(self, locality: int) -> None:
        self.locality = locality


class StepTelemetry:
    """Per-host step-record emitter.

    Steps ingest straight into a columnar
    :class:`~repro_torch.core.frame.TraceStore` (``self.trace``) — no per-step
    dataclass materialization on the hot path; ``trace`` still supports the
    full Trace API (``stages()``/``stage()``/``dump_jsonl``) and stages
    expose a ``TaskRecord`` view for compatibility.

    Usage::

        telem = StepTelemetry(node="host3", timeline=tl)
        with telem.step(i) as s:
            with s.phase("data_load"): batch = next(it)
            s.add("read_bytes", batch.nbytes)
            with s.phase("h2d"): batch = batch.to(device)
            with s.phase("compute"): state, loss = train_step(state, batch)
        trace = telem.trace

    Streaming mode (``streaming=True``) additionally mirrors every emitted
    row into ``self.live_window`` — a
    :class:`~repro_torch.core.window.SlidingStageWindow` holding the last
    ``window`` steps (override with ``stream_max_rows``/``stream_span``)
    with running aggregates, so an analyzer can run *inside* the loop at
    every step for O(changed rows) instead of resealing the stage::

        telem = StepTelemetry("host3", timeline=tl, streaming=True)
        stream = RootCauseStream(BigRootsAnalyzer(JAX_FEATURES, timelines=tl),
                                 telem.live_window)
        with telem.step(i) as s: ...
        for cause in stream.step():  # newly confirmed causes, live
            ...

    Wire mode (``wire=True``) buffers each emitted row until
    :meth:`drain_delta` cuts a columnar :class:`StepDelta` — the export
    surface a sharded fleet ships to the launcher's
    :class:`~repro_torch.serve.FleetAggregator` for merged, fleet-wide diagnosis
    (``delta.to_bytes()`` / ``StepDelta.from_bytes`` for cross-process
    transport; pass the object directly in-process).
    """

    # phase name → TIME feature name in the JAX schema
    _PHASE_FEATURES = {
        "data_load": "data_load_time",
        "h2d": "h2d_time",
        "d2h": "d2h_time",
        "ckpt": "ckpt_time",
    }
    _RESOURCE_METRICS = ("cpu", "disk", "network")

    def __init__(
        self,
        node: str,
        timeline: ResourceTimeline | None = None,
        window: int = 1,
        clock=time.time,
        gc_timer: GcTimer | None = None,
        schema: FeatureSchema | None = None,
        streaming: bool = False,
        stream_max_rows: int | None = None,
        stream_span: float | None = None,
        stream_quantile: float = 0.9,
        wire: bool = False,
        wire_pending_cap: int = 65536,
        boot: int | None = None,
    ) -> None:
        self.node = node
        self.timeline = timeline
        self.window = max(int(window), 1)
        self.clock = clock
        self.gc_timer = gc_timer
        self.schema = schema or JAX_FEATURES
        self.trace = TraceStore(self.schema)
        self.live_window: SlidingStageWindow | None = None
        if streaming:
            self.live_window = SlidingStageWindow(
                f"{node}/live", self.schema,
                span=stream_span,
                max_rows=(stream_max_rows if stream_max_rows is not None
                          else self.window),
                quantile=stream_quantile,
            )
        # Wire mode: additionally buffer each emitted row until the next
        # drain_delta() — the sharded-fleet export surface.  ``boot``
        # stamps this producer incarnation so a consumer can tell a
        # restarted host (new boot) from a redelivered delta (same boot).
        # The buffer is bounded (``wire_pending_cap`` rows): if nobody
        # drains — a stalled launcher, or wire=True wired up without a
        # consumer — the oldest rows are dropped (``wire_overflow_drops``)
        # with a one-time warning instead of leaking an always-on loop's
        # memory.
        self.wire = wire
        self.wire_pending_cap = max(int(wire_pending_cap), 1)
        self.wire_overflow_drops = 0
        # ``boot`` defaults to the wall nanosecond stamp; deterministic
        # harnesses (the anomaly scenario engine) inject one so a replay is
        # byte-identical.
        self.boot = time.time_ns() if boot is None else int(boot)
        self._pending: dict[str, list[tuple]] = {}
        self._delta_seq = 0
        self._overflow_warned = False

    def stage_id_for(self, step: int) -> str:
        """Stage = window of `window` consecutive steps (peer pooling)."""
        return f"steps_{(step // self.window) * self.window:06d}"

    @contextmanager
    def step(self, step: int):
        scope = StepScope(node=self.node, step=step, start=self.clock(), clock=self.clock)
        if self.gc_timer is not None:
            self.gc_timer.take()  # reset accumulator at step start
        try:
            yield scope
        finally:
            scope.end = self.clock()
            self._emit(scope)

    # -- record construction ----------------------------------------------------
    def _emit(self, scope: StepScope) -> None:
        features: dict[str, float] = {}
        for phase, feat in self._PHASE_FEATURES.items():
            if phase in scope.phases:
                features[feat] = scope.phases[phase]
        if self.gc_timer is not None:
            features["gc_time"] = self.gc_timer.take()
        features.update(scope.counters)

        # Resource features: Eq. 1-3 window means over the task interval.
        if self.timeline is not None:
            for metric in self._RESOURCE_METRICS:
                val = self.timeline.window_mean(self.node, metric, scope.start, scope.end)
                if val is not None:
                    features[metric] = val

        task_id = f"{self.node}/step{scope.step:06d}"
        self.trace.add_row(
            task_id=task_id,
            stage_id=self.stage_id_for(scope.step),
            node=self.node,
            start=scope.start,
            end=scope.end,
            locality=scope.locality,
            features=features,
        )
        if self.live_window is not None:
            self.live_window.add_row(
                task_id, self.node, scope.start, scope.end,
                scope.locality, features,
            )
            self.live_window.advance(scope.end)
        if self.wire:
            stage_id = self.stage_id_for(scope.step)
            self._pending.setdefault(stage_id, []).append(
                (task_id, self.node, scope.start, scope.end,
                 scope.locality, features)
            )
            if self.pending_rows > self.wire_pending_cap:
                # Nobody is draining: shed the oldest row (stages are
                # created in step order, so the first stage's head is the
                # oldest) and say so once.
                first = next(iter(self._pending))
                rows = self._pending[first]
                rows.pop(0)
                if not rows:
                    del self._pending[first]
                self.wire_overflow_drops += 1
                if not self._overflow_warned:
                    self._overflow_warned = True
                    import warnings

                    warnings.warn(
                        f"StepTelemetry({self.node!r}) wire buffer exceeded "
                        f"{self.wire_pending_cap} rows with no drain_delta() "
                        "consumer; dropping oldest rows",
                        RuntimeWarning,
                        stacklevel=3,
                    )

    # -- wire export (sharded fleet → launcher) -----------------------------
    @property
    def pending_rows(self) -> int:
        return sum(len(rows) for rows in self._pending.values())

    def drain_delta(self) -> StepDelta:
        """Cut a :class:`StepDelta` from the rows emitted since the last
        drain (requires ``wire=True``) and clear the buffer.  Feature dicts
        are columnarized per stage over the union of names seen in the
        batch, with a ``present`` mask so sparse rows round-trip exactly.
        An empty delta (no steps since last drain) is legal and cheap."""
        if not self.wire:
            raise RuntimeError("StepTelemetry(wire=True) required to drain deltas")
        stages: list[StageDelta] = []
        for stage_id, rows in self._pending.items():
            m = len(rows)
            names = sorted({nm for *_ , feats in rows for nm in feats})
            columns = {nm: np.zeros(m, dtype=np.float64) for nm in names}
            present = {nm: np.zeros(m, dtype=bool) for nm in names}
            starts = np.empty(m, dtype=np.float64)
            ends = np.empty(m, dtype=np.float64)
            locality = np.zeros(m, dtype=np.int16)
            task_ids: list[str] = []
            nodes: list[str] = []
            for i, (tid, node, t0, t1, loc, feats) in enumerate(rows):
                task_ids.append(tid)
                nodes.append(node)
                starts[i], ends[i], locality[i] = t0, t1, loc
                for nm, val in feats.items():
                    columns[nm][i] = float(val)
                    present[nm][i] = True
            stages.append(StageDelta(stage_id, task_ids, nodes, starts, ends,
                                     locality, columns, present))
        self._pending = {}
        self._delta_seq += 1
        return StepDelta(self.node, self._delta_seq, stages, boot=self.boot)

    # -- merging (multi-host traces are concatenated by the launcher) -----------
    def merge_into(self, trace) -> None:
        """Append this host's records into ``trace``.

        A :class:`~repro_torch.core.frame.TraceStore` target takes the columnar
        merge path (per-stage block concatenation — no TaskRecord
        materialization); anything else falls back to the dataclass loop.
        """
        if isinstance(trace, TraceStore):
            trace.merge(self.trace)
            return
        for stage in self.trace.stages():
            for task in stage.tasks:
                trace.add_task(task)
