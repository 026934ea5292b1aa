"""Fleet-sweep batching: pack many sliding windows into one gate launch.

An always-on diagnosis service runs BigRoots once per step per stage
window; a *fleet sweep* runs it for every live window on the cluster (all
jobs, all stages) in the same tick — the "spatio-temporal, whole-fleet"
regime.  The Eq. 5 gate algebra is identical for every window, so instead
of W sequential numpy passes the sweep packs all windows into padded
``[n_windows, max_rows, F]`` arrays and evaluates the gates in a
single :mod:`repro_torch.kernels.bigroots_gates` launch
(``BigRootsAnalyzer.analyze_fleet``).  :class:`GateStaging` carries the
packed batch to the device and the gate bits back: pinned host scratch
that the packer fills in place, device-side inputs and output kept per
batch shape, one asynchronous copy per array and one read-back per tick.

What gets packed (per window, straggler rows only — the gates are only
ever *emitted* for straggler rows, so packing the full window would do
~100× the work for identical output):

- the gate-space ``v`` rows of the stragglers,
- their per-row node aggregates (``node_vsums[code]`` and the derived
  inter/intra peer counts) gathered from the window's running sums,
- the window scalars: running ``Σv``, the λq thresholds from the window's
  P² sketch (or exact quantiles in reference mode), and the NUMERICAL
  stage-mean>0 guard,
- schema-constant column vectors: the TIME significance floor
  (−inf on non-TIME columns so the comparison is vacuous).

Rows are zero-padded to the widest window; ``rowmask`` marks real rows so
padding can never fire a gate.  :func:`eval_gates_np` is the numpy oracle
over the same packed layout — the ``backend="numpy"`` path of
``analyze_fleet`` and the ground truth the kernel equivalence suite pins
the CUDA kernel and its plain PyTorch version against.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..kernels import bigroots_gates
from .features import FeatureKind, FeatureSchema
from .window import SlidingStageWindow


@dataclass
class FleetGateBatch:
    """Padded gate-kernel inputs for a fleet sweep (see module docstring)."""

    v: np.ndarray          # [W, R, F] gate-space straggler rows
    peer_vsum: np.ndarray  # [W, R, F] per-row node Σv
    inter_cnt: np.ndarray  # [W, R, 1] n - count(node)
    intra_cnt: np.ndarray  # [W, R, 1] count(node) - 1
    rowmask: np.ndarray    # [W, R, 1] 1.0 real row / 0.0 padding
    vsum: np.ndarray       # [W, 1, F] running Σv per window
    q: np.ndarray          # [W, 1, F] λq thresholds per window
    numok: np.ndarray      # [W, 1, F] NUMERICAL mean>0 guard
    floor: np.ndarray      # [1, 1, F] TIME floor (−inf elsewhere)
    counts: np.ndarray     # [W] real (unpadded) rows per window
    #: The pinned host tensors that the nine gate arrays above are numpy
    #: views of (same order), when the batch was packed for a CUDA device;
    #: ``None`` for plain numpy arrays.
    pinned: tuple | None = None

    @property
    def shape(self) -> tuple[int, int, int]:
        return self.v.shape


def column_floor(schema: FeatureSchema, time_floor: float) -> np.ndarray:
    """Per-column TIME significance floor: ``time_floor`` on TIME columns,
    −inf elsewhere (``v > −inf`` is vacuously true for finite v)."""
    floor = np.full(len(schema), -np.inf, dtype=np.float64)
    tcols = schema.cols_of_kind(FeatureKind.TIME)
    if tcols.size:
        floor[tcols] = time_floor
    return floor


def pack_windows(
    entries: Sequence[tuple[SlidingStageWindow, np.ndarray, int, np.ndarray, np.ndarray]],
    schema: FeatureSchema,
    time_floor: float,
    scratch: FleetGateBatch | None = None,
    row_bucket: int = 256,
    pin: bool = False,
) -> FleetGateBatch:
    """Stack per-window straggler gate inputs into one padded batch.

    ``entries`` holds ``(window, s_rows, n, V, q)`` per window: the
    straggler row indices into the window buffers, the live count, the
    pre-gathered gate-space rows ``V = window.v[s_rows]`` and the λq
    threshold vector (sketch or exact — the caller's choice is what the
    batch becomes).

    The row dimension is rounded up to a ``row_bucket`` multiple (``row_bucket``): the straggler count drifts every tick,
    and bucketing both keeps the device-side staging buffers to one set per
    bucket and stabilizes the batch shape so ``scratch`` actually hits.
    ``scratch`` (a batch from a previous pack) is reused in place when its
    shape still matches: an always-on sweep packs every tick, and
    re-faulting fresh multi-MB pages each time costs more than the gate
    evaluation.  The returned batch aliases the scratch in that case —
    callers must not hold onto a previous tick's batch across packs.

    ``pin=True`` (the CUDA path) allocates a fresh batch as page-locked
    host tensors and fills their numpy views, so that the copy to the
    device can be asynchronous; the tensors ride along as
    ``batch.pinned``.  The values packed are the same either way.
    """
    W = len(entries)
    F = len(schema)
    R = max((e[3].shape[0] for e in entries), default=0)
    if row_bucket > 1:
        R = max(row_bucket, ((R + row_bucket - 1) // row_bucket) * row_bucket)
    num = schema.cols_of_kind(FeatureKind.NUMERICAL)

    if scratch is not None and scratch.shape == (W, R, F):
        v, peer_vsum = scratch.v, scratch.peer_vsum
        inter_cnt, intra_cnt = scratch.inter_cnt, scratch.intra_cnt
        rowmask = scratch.rowmask
        vsum, qa, numok = scratch.vsum, scratch.q, scratch.numok
        numok[:] = 1.0
        counts = scratch.counts
        counts[:] = 0
        floor = scratch.floor
        pinned = scratch.pinned
    else:
        # np.empty + per-window tail zeroing: the padded tail is usually a
        # sliver of the batch, and fresh zeroed pages for multi-MB buffers
        # cost more than the gate evaluation itself.
        shapes = ((W, R, F), (W, R, F), (W, R, 1), (W, R, 1), (W, R, 1),
                  (W, 1, F), (W, 1, F), (W, 1, F), (1, 1, F))
        pinned = None
        if pin:
            pinned = tuple(
                torch.empty(s, dtype=torch.float64, pin_memory=True)
                for s in shapes
            )
            arrays = [t.numpy() for t in pinned]
        else:
            arrays = [np.empty(s, dtype=np.float64) for s in shapes]
        (v, peer_vsum, inter_cnt, intra_cnt, rowmask, vsum, qa, numok,
         floor) = arrays
        vsum[:] = 0.0
        qa[:] = 0.0
        numok[:] = 1.0
        counts = np.zeros(W, dtype=np.int64)

    for i, (w, s_rows, n, V, q) in enumerate(entries):
        cnt = V.shape[0]
        counts[i] = cnt
        # Padding: zero values, benign counts of 1.0 (divisions stay
        # finite) and rowmask 0.0 so padded rows can never fire.
        v[i, cnt:] = 0.0
        peer_vsum[i, cnt:] = 0.0
        inter_cnt[i, cnt:] = 1.0
        intra_cnt[i, cnt:] = 1.0
        rowmask[i, cnt:] = 0.0
        if cnt == 0:
            continue
        codes = w.node_codes[s_rows]
        cnt_i = w.node_counts[codes]
        v[i, :cnt] = V
        peer_vsum[i, :cnt] = w.node_vsums[codes]
        inter_cnt[i, :cnt, 0] = n - cnt_i
        intra_cnt[i, :cnt, 0] = cnt_i - 1.0
        rowmask[i, :cnt, 0] = 1.0
        vsum[i, 0] = w.vsum
        qa[i, 0] = q
        if num.size:
            numok[i, 0, num] = (w.vsum[num] / n) > 0

    floor[0, 0] = column_floor(schema, time_floor)
    return FleetGateBatch(v, peer_vsum, inter_cnt, intra_cnt, rowmask,
                          vsum, qa, numok, floor, counts, pinned)


class GateStaging:
    """Carries packed gate batches to ``device`` and the gate bits back.

    On a CUDA device the nine inputs and the int8 output live on the
    device once per batch shape (``row_bucket`` in :func:`pack_windows`
    keeps the shape stable tick to tick); each tick is nine
    ``copy_(non_blocking=True)`` from the batch's pinned host tensors on
    the current stream, one kernel launch and one ``.cpu()`` of the
    output, which is the tick's only synchronisation.  On the CPU the
    arrays are viewed with ``torch.from_numpy`` and nothing is copied.

    With ``record_events=True`` CUDA events are recorded around the three
    phases and :attr:`last_ms` holds ``(h2d, kernel, d2h)`` in
    milliseconds after each :meth:`run` (``None`` on the CPU), and
    :attr:`last_span` the host clock (``time.perf_counter``) at the start
    and the end of that :meth:`run`.  :meth:`last_inputs` gives the nine
    tensors the last launch read.
    """

    def __init__(self, device: torch.device, *,
                 record_events: bool = False) -> None:
        self.device = device
        self.record_events = bool(record_events)
        self.last_ms: tuple[float, float, float] | None = None
        self.last_span: tuple[float, float] | None = None
        self._shape: tuple[int, int, int] | None = None
        self._inputs: tuple = ()
        self._out: torch.Tensor | None = None

    def last_inputs(self) -> tuple:
        """The nine input tensors of the last :meth:`run`, where the gate
        function read them (``v`` first, so ``last_inputs()[0].shape`` is the
        batch shape); empty before the first run.  They are overwritten by
        the next run: clone to keep."""
        return self._inputs

    def run(self, batch: FleetGateBatch, peer_mean: float) -> np.ndarray:
        """``gbits [W, R, F]`` int8 on the host for one packed batch."""
        t0 = time.perf_counter()
        gbits = self._run(batch, peer_mean)
        self.last_span = (t0, time.perf_counter())
        return gbits

    def _run(self, batch: FleetGateBatch, peer_mean: float) -> np.ndarray:
        arrays = (batch.v, batch.peer_vsum, batch.inter_cnt, batch.intra_cnt,
                  batch.rowmask, batch.vsum, batch.q, batch.numok,
                  batch.floor)
        if batch.pinned is not None:
            host = batch.pinned
        else:
            host = tuple(torch.from_numpy(a) for a in arrays)
        if self.device.type != "cuda":
            self.last_ms = None
            self._inputs = host
            return bigroots_gates.gates_launch(
                *host, peer_mean=peer_mean
            ).numpy()
        if self._shape != batch.shape:
            self._shape = batch.shape
            self._inputs = tuple(
                torch.empty(t.shape, dtype=torch.float64, device=self.device)
                for t in host
            )
            self._out = torch.empty(batch.shape, dtype=torch.int8,
                                    device=self.device)
        events = None
        if self.record_events:
            events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            events[0].record()
        for dev, src in zip(self._inputs, host):
            dev.copy_(src, non_blocking=True)
        if events:
            events[1].record()
        bigroots_gates.gates_launch(*self._inputs, peer_mean=peer_mean,
                                    out=self._out)
        if events:
            events[2].record()
        gbits = self._out.cpu()
        if events:
            events[3].record()
            events[3].synchronize()
            self.last_ms = tuple(
                events[i].elapsed_time(events[i + 1]) for i in range(3)
            )
        return gbits.numpy()


@dataclass
class ForecastBatch:
    """Padded per-node telemetry sequences for one forecast launch.

    The forecasting hop rides the same sweep that packs
    :class:`FleetGateBatch`: per live window, per node, the last
    ``length`` gate-space rows become one sequence, *left*-padded (mask
    0.0) when a node's history is shorter — so the batched launch scores
    exactly what a per-node call over the unpadded tail would.
    """

    x: np.ndarray      # [S, L, F] gate-space rows, newest step last
    mask: np.ndarray   # [S, L] 1.0 real step / 0.0 left padding
    nodes: list        # [S] node name per sequence
    stage_ids: list    # [S] owning window's stage_id per sequence
    task_ids: list     # [S] newest task_id per sequence (the anchor row)
    count: int         # real (unpadded) sequences; rows >= count are all-pad

    @property
    def shape(self) -> tuple[int, int, int]:
        return self.x.shape


def pack_sequences(
    windows: Sequence[SlidingStageWindow],
    schema: FeatureSchema,
    length: int,
    seq_bucket: int = 256,
) -> ForecastBatch:
    """Gather per-node trailing sequences from live windows → one batch.

    Within a window, a node's live rows are taken in insertion order
    (ring order == time order for a sliding window) and the trailing
    ``length`` of them form its sequence.  The sequence dimension is
    rounded up to a ``seq_bucket`` multiple for the same reason
    :func:`pack_windows` buckets rows:
    stable shapes tick to tick.  Bucket-padding sequences are all-pad
    (mask 0.0 everywhere) and are dropped by ``count`` before emission.
    """
    F = len(schema)
    seqs: list[tuple[np.ndarray, int, str, str, str]] = []
    for w in windows:
        live = w.live_index()
        if live.size == 0:
            continue
        codes = w.node_codes[live]
        for code in np.unique(codes):
            rows = live[codes == code]
            tail = rows[-length:]
            V = w.v[tail]
            seqs.append(
                (V, V.shape[0], w.node_name(int(code)), w.stage_id,
                 w.task_id(int(tail[-1])))
            )
    S = len(seqs)
    S_pad = S
    if seq_bucket > 1:
        S_pad = max(seq_bucket, ((S + seq_bucket - 1) // seq_bucket) * seq_bucket)
    x = np.zeros((S_pad, length, F), dtype=np.float64)
    mask = np.zeros((S_pad, length), dtype=np.float64)
    nodes, stage_ids, task_ids = [], [], []
    for i, (V, n, node, stage_id, task_id) in enumerate(seqs):
        x[i, length - n :] = V
        mask[i, length - n :] = 1.0
        nodes.append(node)
        stage_ids.append(stage_id)
        task_ids.append(task_id)
    return ForecastBatch(x, mask, nodes, stage_ids, task_ids, S)


def eval_gates_np(batch: FleetGateBatch, peer_mean: float) -> np.ndarray:
    """Numpy oracle for the packed gate pipeline → ``gbits [W, R, F]``.

    Bit-for-bit the same comparisons (and operand order) as the kernel;
    used as the ``backend="numpy"`` fleet path and as the ground truth in
    the kernel equivalence tests.
    """
    with np.errstate(invalid="ignore", divide="ignore"):
        inter = (batch.vsum - batch.peer_vsum) / batch.inter_cnt
        intra = (batch.peer_vsum - batch.v) / batch.intra_cnt
        gate_inter = (batch.v > inter * peer_mean) & (batch.inter_cnt > 0.0)
        gate_intra = (batch.v > intra * peer_mean) & (batch.intra_cnt > 0.0)
        fired = (
            (batch.rowmask > 0.0)
            & (batch.v > batch.q)
            & (gate_inter | gate_intra)
            & (batch.numok > 0.0)
            & (batch.v > batch.floor)
        )
    gbits = gate_inter.astype(np.int8) + 2 * gate_intra.astype(np.int8)
    return np.where(fired, gbits, np.int8(0))
