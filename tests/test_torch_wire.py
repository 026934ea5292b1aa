"""The delta wire codec is carried unchanged: the port's
``StepDelta.to_bytes()`` must equal the reference's bytes (v1, v2, and v3
with an attribution block; tolerance 0) and each side must decode the
other's payloads."""
from __future__ import annotations

import numpy as np
import pytest

import repro.core as ref_core
import repro.telemetry.events as ref_ev
import repro_torch.core as port_core
import repro_torch.telemetry.events as port_ev


def make_delta(ev, core, seed, with_causes):
    rng = np.random.default_rng(seed)
    stages = []
    for k in range(3):
        m = int(rng.integers(1, 40))
        names = ["cpu", "read_bytes", "gc_time", "data_load_time"][: int(rng.integers(1, 5))]
        columns = {nm: rng.uniform(0, 1e6, m) for nm in names}
        present = {nm: rng.random(m) > 0.2 for nm in names}
        starts = np.sort(rng.uniform(0, 100, m))
        stages.append(ev.StageDelta(
            f"steps_{k:06d}", [f"h{seed}/step{i:06d}" for i in range(m)],
            [f"h{seed}" for _ in range(m)], starts,
            starts + rng.uniform(0.5, 3.0, m),
            rng.integers(0, 3, m).astype(np.int16), columns, present))
    causes = []
    if with_causes:
        attr = core.Attribution(
            estimated_recovery_s=1.25, throughput_delta=0.125,
            cumulative_recovery_s=2.5, tasks_rebased=1, baseline_s=10.0)
        causes = [core.cause_to_wire(core.RootCause(
            task_id="h0/step000001", stage_id="steps_000000", node="h0",
            feature="cpu", kind=core.FeatureKind.RESOURCE, value=0.95,
            peer_groups=("inter",), guidance="g", severity=2,
            attribution=attr))]
    return ev.StepDelta(f"h{seed}", 7, stages, boot=1234, causes=causes)


def same_delta(a, b):
    assert (a.host, a.seq, a.boot, a.causes) == (b.host, b.seq, b.boot, b.causes)
    assert len(a.stages) == len(b.stages)
    for s, t in zip(a.stages, b.stages):
        assert (s.stage_id, s.task_ids, s.nodes) == (t.stage_id, t.task_ids, t.nodes)
        for x, y in ((s.starts, t.starts), (s.ends, t.ends),
                     (s.locality, t.locality)):
            assert np.asarray(x).tobytes() == np.asarray(y).tobytes()
        assert list(s.columns) == list(t.columns)
        for nm in s.columns:
            np.testing.assert_array_equal(s.present[nm], t.present[nm])
            m = np.asarray(s.present[nm], dtype=bool)
            np.testing.assert_array_equal(np.asarray(s.columns[nm])[m],
                                          np.asarray(t.columns[nm])[m])


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("version,with_causes",
                         [(1, False), (2, False), (3, False), (3, True),
                          (None, False), (None, True)])
def test_bytes_equal_and_cross_decode(version, with_causes, seed):
    ref = make_delta(ref_ev, ref_core, seed, with_causes)
    port = make_delta(port_ev, port_core, seed, with_causes)
    rb, pb = ref.to_bytes(version), port.to_bytes(version)
    assert pb == rb
    want_version = version or (3 if with_causes else 2)
    assert port_ev.StepDelta.wire_version(rb) == want_version
    same_delta(port_ev.StepDelta.from_bytes(rb), ref_ev.StepDelta.from_bytes(pb))
    # round trip through the other side re-serializes to the same bytes
    assert port_ev.StepDelta.from_bytes(rb).to_bytes(version) == \
        ref_ev.StepDelta.from_bytes(pb).to_bytes(version)


def test_causes_refused_on_old_versions_and_bad_magic():
    port = make_delta(port_ev, port_core, 0, True)
    with pytest.raises(ValueError, match="cannot encode"):
        port.to_bytes(2)
    with pytest.raises(port_ev.WireFormatError):
        port_ev.StepDelta.from_bytes(b"NOPE" + b"\x00" * 16)


def test_forwarded_envelope_bytes_equal():
    inner = [make_delta(ref_ev, ref_core, s, False).to_bytes() for s in range(3)]
    ref = ref_ev.ForwardedDelta("agg0", 5, inner, boot=99).to_bytes()
    port = port_ev.ForwardedDelta("agg0", 5, inner, boot=99).to_bytes()
    assert port == ref
    assert port_ev.ForwardedDelta.is_forwarded(ref)
    assert port_ev.ForwardedDelta.from_bytes(ref).payloads == inner


def test_step_telemetry_drain_bytes_equal():
    out = []
    for ev in (ref_ev, port_ev):
        ticks = iter(np.arange(0.0, 100.0, 0.5).tolist())
        telem = ev.StepTelemetry("h0", wire=True, window=2, boot=5,
                                 clock=lambda: next(ticks))
        for step in range(5):
            with telem.step(step) as s:
                with s.phase("data_load"):
                    pass
                s.add("read_bytes", 1000.0 * step)
        out.append(telem.drain_delta().to_bytes())
    assert out[0] == out[1]


def test_cause_wire_dicts_equal():
    ref = make_delta(ref_ev, ref_core, 0, True).causes
    port = make_delta(port_ev, port_core, 0, True).causes
    assert ref == port and list(ref[0]) == list(port[0])
    assert port_core.cause_to_wire(port_core.cause_from_wire(ref[0])) == ref[0]
