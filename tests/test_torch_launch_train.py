"""The training driver ``repro_torch.launch.train`` on the CPU at smoke size,
the port's counterpart of ``tests/test_integration_e2e.py::TestTrainDriver``
(``device="cpu"``: the kernels' plain versions, the same Function path as
the card)."""
from __future__ import annotations

import json

import pytest
from conftest import requires_grad_through_barrier

from repro_torch.ckpt import CheckpointManager
from repro_torch.core import Trace
from repro_torch.launch import train


def make_args(module=train, **overrides):
    args = module.build_argparser().parse_args([])
    args.smoke = True
    args.steps = 24
    args.batch = 2
    args.seq = 32
    args.window = 8
    args.anomaly = "none"
    if module is train:
        args.device = "cpu"
    for k, v in overrides.items():
        setattr(args, k, v)
    return args


def test_loss_decreases_and_trace_emitted(tmp_path):
    args = make_args(arch="mamba2_130m",
                     trace_out=str(tmp_path / "trace.jsonl"),
                     report_out=str(tmp_path / "report.md"))
    out = train.run(args)
    assert out["loss_decreased"]
    assert out["steps"] == 24
    trace = Trace.load_jsonl(str(tmp_path / "trace.jsonl"))
    assert trace.num_tasks == args.steps
    report = (tmp_path / "report.md").read_text()
    assert report.startswith("# BigRoots report")
    assert '"loss_decreased": true' in report


def test_checkpointing_in_loop(tmp_path):
    args = make_args(arch="mamba2_130m", ckpt_dir=str(tmp_path / "ck"),
                     ckpt_every=8, async_ckpt=True)
    train.run(args)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.steps() == [8, 16]          # keep=2, saves at steps 8 and 16


def test_data_skew_flows_through():
    args = make_args(arch="mamba2_130m", skew_factor=3.0, steps=16)
    assert train.run(args)["steps"] == 16


def test_moe_with_accumulation_and_compression(tmp_path):
    """granite-moe (attention, MoE, tied embeddings) through the kernel
    paths' plain versions, two microbatches a step, int8 gradients with
    error feedback."""
    args = make_args(arch="granite_moe_1b_a400m", steps=6, accum=2,
                     compress_grads=True, batch=4, seq=16,
                     ckpt_dir=str(tmp_path / "ck"), ckpt_every=5)
    out = train.run(args)
    assert out["arch"] == "granite-moe-1b-a400m-smoke"
    assert out["final_loss"] == out["final_loss"]       # not NaN
    assert CheckpointManager(str(tmp_path / "ck")).latest_step() == 5


@requires_grad_through_barrier
def test_the_reference_drivers_keys():
    """The report's JSON has the reference driver's keys."""
    from repro.launch import train as ref_train

    want = ref_train.run(make_args(ref_train, arch="mamba2_130m", steps=2))
    got = train.run(make_args(arch="mamba2_130m", steps=2))
    assert list(got) == list(want)
    assert list(got["injection"]) == list(want["injection"])
    assert got["report"].splitlines()[0] == want["report"].splitlines()[0] \
        .replace("mamba2-130m-smoke", got["arch"])


def test_main_prints_the_report_and_json(capsys):
    train.main(["--arch", "mamba2_130m", "--smoke", "--device", "cpu",
                "--steps", "3", "--batch", "2", "--seq", "16",
                "--window", "4"])
    out = capsys.readouterr().out
    body = out[out.index("\n{"):]
    parsed = json.loads(body)
    assert parsed["steps"] == 3 and "report" not in parsed
    assert out.startswith("# BigRoots report")


def test_the_default_device_is_the_gpu(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.run(make_args(arch="mamba2_130m", device=None, steps=1))
