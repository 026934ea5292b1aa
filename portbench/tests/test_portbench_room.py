"""A configuration added as new files only.

The configuration here is built in the test: it names a reference module
of its own, lists one more traced entry than a serving cell's default
(the SSD scan, ``ops.ssd_chunked_cuda``) with a recorder of its own, a
per-layer reader of that span's calls, and its own cut widths.  Those
files sit in a folder of the test's, searched before the benchmark's, and
nothing of the harness is edited: the serving driver must take the
module's weights and logits, and hand the extra span's calls to the
reader."""
from __future__ import annotations

import copy

import torch

from portbench.harness import common, weights
from portbench.harness.metrics import read_all
from portbench.harness.serve import ENTRIES, ServeCell
from portbench.tests import smoke

#: Appended to a copy of the ``lm`` reference: its own init (every std
#: half as large again) and counts of the calls the harness makes.
ROOM = '''

CALLS = {"shapes": 0, "logits_at": 0}
_lm_shapes, _lm_init, _lm_logits_at = shapes, init, logits_at


def shapes(m):
    CALLS["shapes"] += 1
    return _lm_shapes(m)


def init(m, path):
    rule = _lm_init(m, path)
    return rule if isinstance(rule, str) else 1.5 * rule


def logits_at(*args, **kwargs):
    CALLS["logits_at"] += 1
    return _lm_logits_at(*args, **kwargs)
'''
RECORDER = '''
def record(a, k, out):
    return tuple(a[0].shape)
'''
READER = '''
def read(ctx):
    calls = ctx["calls"].get("ssd_room")
    return len(calls) if calls else None
'''


def test_a_new_configuration_needs_only_new_files(tmp_path, monkeypatch):
    lm_file = common.BENCH / "reference" / "lm.py"
    for kind, name, text in (("reference", "room",
                              lm_file.read_text() + ROOM),
                             ("entries", "ssd_room", RECORDER),
                             ("metrics", "ssd_room_calls", READER)):
        (tmp_path / kind).mkdir()
        (tmp_path / kind / f"{name}.py").write_text(text)
    monkeypatch.setattr(common, "SEARCH", [tmp_path, common.BENCH])

    c = copy.deepcopy(common.cell("jamba.serve.prompt"))
    config = dict(c["config"], name="room", reference="room",
                  entries=ENTRIES + [{"entry": "ssd_chunked_cuda",
                                      "span": "ssd_room"}],
                  smoke={"serve": dict(smoke.SERVE_MODEL, d_model=128)})
    reader = {"name": "ssd_room_calls", "unit": "calls", "better": "lower",
              "source": "program_counter", "layer": "kernels",
              "moves": "serve_tokens_per_s"}
    cell = smoke.shrink(dict(c, name="room.serve.prompt", config=config,
                             metrics={"end_to_end": [],
                                      "per_layer": [reader]}))
    # One round serves the whole sample, however slow the host.
    cell["workload"]["clients"] = cell["workload"]["check"][
        "sample_requests"]

    run = ServeCell(cell, 2_147_483_659, smoke.CPU, model=smoke.widths(cell))
    room = common.load("reference", "room")
    assert run.ref is room and run.m["d_model"] == 128
    run.setup()
    run.trace_entries()
    w = run.window(2.0)
    ctx = run.layer_context(w)
    got = read_all(cell["metrics"]["per_layer"], ctx)
    run.close()
    run.free()
    checks = run.check()

    made = weights.flat(weights.make(room, run.m, run.seed, smoke.CPU,
                                     torch.float32, keep_f32=True))
    lm = weights.flat(weights.make(common.load("reference", "lm"), run.m,
                                   run.seed, smoke.CPU, torch.float32,
                                   keep_f32=True))
    served = weights.flat(run.params)
    assert list(served) == list(made)
    assert all(torch.equal(served[p], made[p]) for p in made)
    assert not torch.equal(made["embed"], lm["embed"])
    assert room.CALLS["shapes"] >= 1 and room.CALLS["logits_at"] >= 1
    assert common.is_correct(checks), (checks, getattr(run, "info", None))

    assert ctx["calls"]["ssd_room"] and ctx["calls"]["moe_gmm"]
    assert got["ssd_room_calls"]["value"] == len(ctx["calls"]["ssd_room"])
    assert not any((common.BENCH / kind / f"{name}.py").exists()
                   for kind, name in (("reference", "room"),
                                      ("entries", "ssd_room"),
                                      ("metrics", "ssd_room_calls")))


def test_each_configuration_names_a_reference_the_harness_loads():
    for entry in common.benchmark()["configs"]:
        config = common.load_json(common.ROOT / entry["file"])
        ref = common.reference(config)
        assert ref.__file__ == str(common.BENCH / "reference"
                                   / f"{config['reference']}.py")


def test_the_harness_imports_no_reference_model():
    for path in (common.BENCH / "harness").glob("*.py"):
        text = path.read_text()
        assert "reference import lm" not in text, path
        assert "reference.lm" not in text, path
