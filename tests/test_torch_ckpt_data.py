"""Checkpoints, the supervisor and the data pipeline: ``repro_torch`` against
``repro``.

- ``HostDataLoader`` batches and their metadata are byte-identical.
- The reference's checkpoint, supervisor and data tests
  (``tests/test_substrate.py``, ``tests/test_ft.py::TestSupervisorBackoff``)
  run on the port.
- A checkpoint written by either package restores in the other, leaf for
  leaf and byte for byte (one on-disk format: per-leaf ``.npy`` in the
  reference's flatten order).
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ckpt as ref_ckpt
import repro.train as ref_train
from repro.configs import get_config as ref_config
from repro.data import pipeline as ref_pipeline
from repro.models import Model as RefModel, smoke_variant as ref_smoke
from repro_torch import tree
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_to_numpy, train_state_from_numpy
from repro_torch.data.pipeline import DataConfig, HostDataLoader, Prefetcher
from repro_torch.ft import RestartBudgetExceeded, Supervisor
from repro_torch.models import Model, smoke_variant
from repro_torch.train import AdamWConfig, init_state


# -- data ---------------------------------------------------------------------

@pytest.mark.parametrize("kw,host,hosts", [
    (dict(vocab=100, seq_len=16, batch_per_host=2, seed=3), 0, 4),
    (dict(vocab=49155, seq_len=64, batch_per_host=3), 1, 2),
    (dict(vocab=256, seq_len=8, batch_per_host=2, skew_host=0,
          skew_factor=4.0), 0, 2),
    (dict(vocab=256, seq_len=8, batch_per_host=2, embed_tokens=4,
          d_model=16, enc_frames=2), 0, 1),
])
def test_batches_are_byte_identical(kw, host, hosts):
    port = HostDataLoader(DataConfig(**kw), host, hosts)
    ref = ref_pipeline.HostDataLoader(ref_pipeline.DataConfig(**kw), host,
                                      hosts)
    for step in (0, 1, 17):
        (got, got_meta), (want, want_meta) = port.batch_at(step), \
            ref.batch_at(step)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes()
        assert (got_meta.read_bytes, got_meta.locality) == (
            want_meta.read_bytes, want_meta.locality)


def test_data_pipeline_behaviour():
    """The reference's ``TestDataPipeline`` on the port."""
    cfg = DataConfig(vocab=100, seq_len=16, batch_per_host=2, seed=3)
    np.testing.assert_array_equal(HostDataLoader(cfg, 0, 4).batch_at(7)[0]
                                  ["tokens"], HostDataLoader(cfg, 0, 4)
                                  .batch_at(7)[0]["tokens"])
    assert not np.array_equal(HostDataLoader(cfg, 0, 4).batch_at(0)[0]
                              ["tokens"], HostDataLoader(cfg, 1, 4)
                              .batch_at(0)[0]["tokens"])
    batch, _ = HostDataLoader(cfg, 0, 1).batch_at(0)
    np.testing.assert_array_equal(batch["labels"][:, :-1],
                                  batch["tokens"][:, 1:])
    skew = DataConfig(vocab=100, seq_len=16, batch_per_host=2, skew_host=0,
                      skew_factor=4.0)
    _, m0 = HostDataLoader(cfg, 0, 2).batch_at(0)
    _, m1 = HostDataLoader(skew, 0, 2).batch_at(0)
    _, m2 = HostDataLoader(skew, 1, 2).batch_at(0)
    assert m1.read_bytes > 3 * m0.read_bytes
    assert m2.read_bytes == pytest.approx(m0.read_bytes)


def test_prefetcher():
    loader = HostDataLoader(DataConfig(vocab=100, seq_len=8,
                                       batch_per_host=1), 0, 1)
    with Prefetcher(loader, depth=2, start_step=5) as pf:
        b5, _ = pf.next()
        b6, _ = pf.next()
    np.testing.assert_array_equal(b5["tokens"], loader.batch_at(5)[0]
                                  ["tokens"])
    np.testing.assert_array_equal(b6["tokens"], loader.batch_at(6)[0]
                                  ["tokens"])
    assert not pf._thread.is_alive()


# -- the checkpoint manager ---------------------------------------------------

def _tree(x=1.0):
    return {"a": torch.full((4, 3), x), "b": {"c": torch.arange(5)}}


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    t = _tree(2.5)
    mgr.save(10, t)
    out = mgr.restore(tree.map(lambda x: torch.empty(x.shape,
                                                     device="meta"), t))
    np.testing.assert_array_equal(out["a"], t["a"].numpy())
    np.testing.assert_array_equal(out["b"]["c"], t["b"]["c"].numpy())
    on_dev = mgr.restore(t, device="cpu")
    assert torch.equal(on_dev["a"], t["a"])
    assert torch.equal(on_dev["b"]["c"], t["b"]["c"])


def test_latest_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, _tree(step))
    assert mgr.steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_async_save_snapshots_before_returning(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree(1.0)
    mgr.save(5, t, blocking=False)
    t["a"].fill_(7.0)      # the caller moves on; the snapshot does not
    mgr.wait()
    assert mgr.latest_step() == 5
    assert float(mgr.restore(t)["a"].max()) == 1.0


def test_atomicity_no_tmp_dirs_visible(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(1, _tree())
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]


def test_shape_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"a": torch.empty(9, 9), "b": {"c": torch.empty(5)}})
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore({"a": torch.empty(4, 3)})


def test_restore_train_state_roundtrip(tmp_path):
    """The reference's ``test_restore_train_state_roundtrip`` on the port:
    a train state (params, AdamW state, residual) into a template of
    another seed's state."""
    model = Model(smoke_variant(get_config("granite_8b")))
    state = init_state(model, torch.Generator().manual_seed(0),
                       AdamWConfig(), compress=True, device="cpu")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, state)
    template = init_state(model, torch.Generator().manual_seed(1),
                          AdamWConfig(), compress=True, device="cpu")
    out = mgr.restore(template, device="cpu")
    assert type(out["opt"]) is type(state["opt"])
    for a, b in zip(tree.leaves(state), tree.leaves(out), strict=True):
        assert torch.equal(a, b)


def test_async_save_error_surfaces_in_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    (tmp_path / "step_00000002.tmp").write_text("in the way")
    mgr.save(2, {"a": torch.ones(2)}, blocking=False)
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()      # the error is raised once
    assert mgr.latest_step() is None


# -- across the packages ------------------------------------------------------

def _ref_state(compress: bool):
    model = RefModel(ref_smoke(ref_config("granite_moe_1b_a400m")))
    opt = ref_train.AdamWConfig()
    state = jax.jit(lambda k: ref_train.init_state(model, k, opt,
                                                   compress=compress))(
        jax.random.key(0))
    state = jax.tree.map(np.asarray, state)
    # moments and step that are not zeros, so the leaves tell apart
    rng = np.random.default_rng(0)
    opt_state = ref_train.AdamWState(
        m=jax.tree.map(lambda p: rng.normal(0, 1, p.shape).astype(p.dtype),
                       state["opt"].m),
        v=jax.tree.map(lambda p: rng.uniform(0, 1, p.shape).astype(p.dtype),
                       state["opt"].v),
        step=np.int32(11))
    return {**state, "opt": opt_state}, model, opt


@pytest.mark.parametrize("compress", [False, True])
def test_reference_checkpoint_restores_in_the_port(tmp_path, compress):
    state, _, _ = _ref_state(compress)
    ref_ckpt.CheckpointManager(str(tmp_path)).save(3, state)
    cfg = smoke_variant(get_config("granite_moe_1b_a400m"))
    template = init_state(Model(cfg), torch.Generator().manual_seed(1),
                          AdamWConfig(), compress=compress, device="cpu")
    got = CheckpointManager(str(tmp_path)).restore(template, device="cpu")
    want = train_state_from_numpy(state, cfg, "cpu")
    assert sorted(got) == sorted(want)
    for g, w in zip(tree.leaves(got), tree.leaves(want), strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("compress", [False, True])
def test_port_checkpoint_restores_in_the_reference(tmp_path, compress):
    state, model, opt = _ref_state(compress)
    cfg = smoke_variant(get_config("granite_moe_1b_a400m"))
    CheckpointManager(str(tmp_path)).save(
        4, train_state_from_numpy(state, cfg, "cpu"))
    got = ref_ckpt.CheckpointManager(str(tmp_path)).restore(
        ref_train.abstract_state(model, opt, compress=compress))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(state),
                    strict=True):
        g = np.asarray(g)
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_params_only_checkpoint_as_the_driver_writes_it(tmp_path):
    """``launch.train`` saves ``state["params"]``: the port's parameters
    restore as the reference's tree (keys and shapes of its
    ``abstract_params``)."""
    cfg = smoke_variant(get_config("mamba2_130m"))
    params = Model(cfg).init(device="cpu")
    CheckpointManager(str(tmp_path)).save(2, params)
    ref_model = RefModel(ref_smoke(ref_config("mamba2_130m")))
    got = ref_ckpt.CheckpointManager(str(tmp_path)).restore(
        ref_model.abstract_params())
    want = lm_params_to_numpy(params)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want), strict=True):
        assert np.asarray(g).tobytes() == w.tobytes()


# -- the supervisor -----------------------------------------------------------

class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


class _NoCkpt:
    """Minimal CheckpointManager stand-in: never restores anything."""

    def latest_step(self):
        return None

    def restore(self, template, step, device=None):  # pragma: no cover
        raise AssertionError("should not restore")


def _sup(**kw):
    clock = FakeClock()
    sleeps: list[float] = []
    kw.setdefault("backoff_s", 1.0)
    sup = Supervisor(_NoCkpt(), None, clock=clock, sleep=sleeps.append, **kw)
    return sup, clock, sleeps


def test_capped_exponential_backoff_with_seeded_jitter():
    sup, _, sleeps = _sup(max_restarts=5, backoff_max_s=4.0, seed=7)
    calls = [0]

    def body(start, state):
        calls[0] += 1
        if calls[0] <= 4:
            raise RuntimeError("boom")
        return "done"

    assert sup.run(body) == "done"
    assert len(sleeps) == 4
    for got, base in zip(sleeps, [1.0, 2.0, 4.0, 4.0]):
        assert base <= got <= base * 1.1
    sup2, _, sleeps2 = _sup(max_restarts=5, backoff_max_s=4.0, seed=7)
    calls[0] = 0
    sup2.run(body)
    assert sleeps2 == sleeps


def test_different_seeds_decorrelate():
    delays = []
    for seed in (0, 1):
        sup, _, sleeps = _sup(max_restarts=2, seed=seed)
        calls = [0]

        def body(start, state):
            calls[0] += 1
            if calls[0] == 1:
                raise RuntimeError("x")
            return 1

        sup.run(body)
        delays.append(sleeps[0])
    assert delays[0] != delays[1]


def test_healthy_run_resets_budget():
    sup, clock, _ = _sup(max_restarts=2, backoff_s=0.0, healthy_reset_s=100.0)
    calls = [0]

    def body(start, state):
        calls[0] += 1
        if calls[0] <= 6:
            clock.t += 0.5 if calls[0] <= 2 else 500.0
            raise RuntimeError(f"crash {calls[0]}")
        return "ok"

    assert sup.run(body) == "ok"
    assert sup.budget_resets >= 1
    assert sup.restarts <= sup.max_restarts


def test_crash_loop_still_exhausts_budget():
    sup, clock, _ = _sup(max_restarts=2, backoff_s=0.0, healthy_reset_s=100.0)

    def body(start, state):
        clock.t += 0.5
        raise RuntimeError("loop")

    with pytest.raises(RestartBudgetExceeded):
        sup.run(body)
    assert sup.budget_resets == 0


def test_the_same_delays_as_the_reference():
    from repro.ft import Supervisor as RefSupervisor

    runs = []
    for cls in (Supervisor, RefSupervisor):
        sleeps: list[float] = []
        sup = cls(_NoCkpt(), None, max_restarts=6, backoff_s=0.5,
                  backoff_max_s=3.0, seed=11, clock=FakeClock(),
                  sleep=sleeps.append)
        calls = [0]

        def body(start, state):
            calls[0] += 1
            if calls[0] <= 5:
                raise RuntimeError("again")
            return calls[0]

        runs.append((sup.run(body), sleeps, sup.restarts, sup.failures))
    assert runs[0] == runs[1]


def test_supervisor_restarts_from_the_checkpoint(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    template = {"x": torch.empty(2, device="meta")}
    attempts, seen = [], []

    def body(start, state):
        attempts.append(start)
        seen.append(state)
        if state is None:
            state = {"x": torch.tensor([1.5, -2.0])}
        mgr.save(5, state)
        if len(attempts) < 3:
            raise RuntimeError("boom")
        return state

    sup = Supervisor(mgr, template, max_restarts=3, device="cpu")
    sup.run(body)
    assert attempts == [0, 6, 6]
    assert sup.restarts == 2
    assert seen[0] is None
    assert torch.equal(seen[1]["x"], torch.tensor([1.5, -2.0]))


def test_supervisor_budget(tmp_path):
    def body(start, state):
        raise RuntimeError("always")

    sup = Supervisor(CheckpointManager(str(tmp_path)), {}, max_restarts=1)
    with pytest.raises(RestartBudgetExceeded):
        sup.run(body)


def test_jnp_leaves_and_numpy_templates_interoperate(tmp_path):
    """The reference writes jax arrays; a numpy template restores them in
    the port without torch on the way."""
    ref_ckpt.CheckpointManager(str(tmp_path)).save(
        1, {"w": jnp.arange(6, dtype=jnp.float32).reshape(2, 3)})
    got = CheckpointManager(str(tmp_path)).restore({"w": np.zeros((2, 3))})
    assert isinstance(got["w"], np.ndarray)
    np.testing.assert_array_equal(got["w"], np.arange(6).reshape(2, 3))
