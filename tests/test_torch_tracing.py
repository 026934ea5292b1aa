"""The program's own spans (``repro_torch.tracing``): recorded only while a
profiler session records, where the work happens in the train step and
the serving engine, without changing a bit of what they compute, and
placed on the profiler's clock through the session's anchor."""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing, tree
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model, smoke_variant
from repro_torch.parallel.sharding import shard_tree
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import AdamWConfig, init_state, make_train_step
from repro_torch.train.step import abstract_state, state_shardings

CPU = torch.device("cpu")
#: The kernel paths (their plain versions on CPU tensors), under remat.
KERNEL_PATHS = dict(attention_impl="cuda", moe_impl="gmm", ssm_impl="cuda",
                    remat=True)


def session():
    return profile(activities=[ProfilerActivity.CPU])


def train_setup(accum: int = 1, sharded: bool = False):
    """A tiny granite-like step, its state and a batch; ``sharded``: the
    sharded step on a (1, 1) mesh (ZeRO-1), on its participant's block."""
    cfg = replace(smoke_variant(get_config("granite_moe_1b_a400m")),
                  **KERNEL_PATHS)
    model = Model(cfg)
    opt = AdamWConfig()
    state = init_state(model, torch.Generator().manual_seed(0), opt,
                       device=CPU)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab, (4, 16)).astype(np.int64))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    if not sharded:
        return make_train_step(model, opt, accum=accum), state, batch
    mesh = make_mesh((1, 1), ("data", "model"))
    shardings = state_shardings(abstract_state(model, opt), cfg, mesh,
                                zero_opt=True)
    step = make_train_step(model, opt, accum, shards=mesh,
                           shardings=shardings)
    return step, shard_tree(state, shardings, {"data": 0, "model": 0}), batch


def serve_engine():
    cfg = replace(smoke_variant(get_config("granite_moe_1b_a400m")),
                  **KERNEL_PATHS)
    model = Model(cfg)
    return ServeEngine(model, model.init(device=CPU), max_len=24,
                       batch_size=2, device=CPU), cfg


def serve_round(engine, cfg, new: int = 3):
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (2, 8))
    return engine.run([Request(f"r{i}", p.astype(np.int32),
                               max_new_tokens=new)
                       for i, p in enumerate(prompts)])


def names(spans):
    return [s.name for s in spans]


def test_off_a_span_records_nothing_and_is_the_shared_noop():
    assert not torch.autograd.profiler._is_profiler_enabled
    before = tracing.spans()
    a, b = tracing.span("x", round=1), tracing.span("y")
    assert a is b
    with a as got:
        assert got is a
    assert tracing.spans() == before


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_records_its_phases_as_children_of_the_step(accum,
                                                               sharded):
    step, state, batch = train_setup(accum, sharded)
    with session():
        step(state, batch)
    got = tracing.spans()
    assert names(got).count("train.step") == 1
    top = next(s for s in got if s.name == "train.step")
    assert top.parent is None
    children = [s for s in got if s.parent is top]
    assert sorted(names(children)) == sorted(
        ["train.forward", "train.backward"] * accum + ["train.optimizer"])
    assert len(got) == len(children) + 1
    for s in children:
        assert top.start_ns <= s.start_ns <= s.end_ns <= top.end_ns
    assert tracing.dropped() == 0


def test_serving_round_records_prefill_and_each_decode_steps_spans():
    engine, cfg = serve_engine()
    serve_round(engine, cfg, new=1)
    with session():
        done = serve_round(engine, cfg, new=3)
    assert [len(r.output) for r in done] == [3, 3]
    got = tracing.spans()
    count = {n: names(got).count(n) for n in set(names(got))}
    assert count == {"serve.round": 1, "serve.prefill": 1,
                     "serve.decode": 3, "serve.token_read": 3}
    top = next(s for s in got if s.name == "serve.round")
    assert engine.rounds == 2
    assert all(s.ids["round"] == 2 for s in got)
    assert all(s.parent is top for s in got if s is not top)
    steps = [s.ids["step"] for s in got if s.name == "serve.decode"]
    assert steps == [0, 1, 2]
    assert steps == [s.ids["step"] for s in got
                     if s.name == "serve.token_read"]


def test_tracing_changes_no_bit_of_training_or_serving():
    def train_twice():
        step, state, batch = train_setup()
        losses = []
        for _ in range(2):
            state, m = step(state, batch)
            losses.append(m["loss"])
        return losses, tree.leaves(state["params"])

    def serve():
        engine, cfg = serve_engine()
        return [r.output for r in serve_round(engine, cfg, new=4)]

    off = train_twice(), serve()
    with session():
        on = train_twice(), serve()
    assert {"train.step", "serve.round"} <= set(names(tracing.spans()))
    (l_off, p_off), t_off = off
    (l_on, p_on), t_on = on
    assert all(torch.equal(a, b) for a, b in zip(l_off, l_on))
    assert all(torch.equal(a, b) for a, b in zip(p_off, p_on))
    assert t_off == t_on


def test_spans_lie_on_their_record_function_ranges_through_the_anchor():
    x = torch.randn(256, 256)
    with session():  # the profiler's and record_function's first use
        with tracing.span("warm"):
            x @ x
    with session() as prof:
        for i in range(5):
            with tracing.span(f"outer{i}"):
                with tracing.span(f"inner{i}"):
                    x @ x
    anchor = tracing.anchor()
    got = tracing.spans()
    assert len(got) == 10
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CPU}
    for s in got:
        e = events[s.name]
        start = anchor.perf_ns_of(e.start_ns())
        end = anchor.perf_ns_of(e.start_ns() + e.duration_ns())
        assert abs(start - s.start_ns) < 1_000_000, s
        assert abs(end - s.end_ns) < 1_000_000, s


def test_a_new_session_clears_the_spans_of_the_one_before():
    with session():
        with tracing.span("first"):
            pass
    first = tracing.anchor()
    assert names(tracing.spans()) == ["first"]
    with session():
        with tracing.span("second"):
            pass
    assert names(tracing.spans()) == ["second"]
    assert tracing.anchor() != first
    with session():
        pass
    assert tracing.spans() == []


def test_spans_past_the_capacity_are_counted_not_kept(monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 2)
    with session():
        for n in "abc":
            with tracing.span(n):
                pass
    assert names(tracing.spans()) == ["a", "b"]
    assert tracing.dropped() == 1


def test_spans_filter_by_their_start():
    with session():
        for n in "abc":
            with tracing.span(n):
                pass
    a, b, c = tracing.spans()
    assert names(tracing.spans(b.start_ns, c.start_ns)) == ["b", "c"]
    assert names(tracing.spans(None, a.start_ns)) == ["a"]
