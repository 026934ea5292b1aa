"""Fault-tolerance demo: diagnose → mitigate → recover, end to end.

Act 1 — closed-loop A/B.  The simulated cluster replays an incident
twice on the same seed and injection schedule: once diagnose-only (the
policy engine in dry-run) and once with the engine armed.  The honest
metric is mean step (stage) time recovered, and the demo asserts the
mitigated arm actually recovers it on both a contention and an
input-skew scenario.  The mitigated arm's audit log is written to a
JSONL file and summarized — including the suppressed decisions, which
is what makes a policy reviewable before it is armed.

Act 2 — crash-restart.  A job that dies mid-run is restarted by the
supervisor from the latest checkpoint (capped-exponential backoff with
seeded jitter) and finishes.

Act 3 — elastic re-mesh.  The hosts the policy cordoned in Act 1 are
handed to ``reshard_plan``: the mesh shrinks along the data axis and
the plan accounts for every chip the cordon idled.

    PYTHONPATH=src python -m repro_torch.examples.fault_tolerance_demo [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from .. import tree
from ..anomaly import ab_compare
from ..ckpt import CheckpointManager
from ..device import resolve_device
from ..ft import Supervisor, reshard_plan

TOTAL = 30


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    device = resolve_device(ap.parse_args(argv).device)
    tmp = tempfile.mkdtemp(prefix="ft_demo_")

    # ---- Act 1: closed-loop A/B — does acting on causes recover step time?
    print("== closed-loop A/B (mitigated vs diagnose-only, same seed) ==")
    cordoned: tuple[str, ...] = ()
    for scenario in ("cpu", "skew"):
        audit_path = os.path.join(tmp, f"audit_{scenario}.jsonl")
        ab = ab_compare(scenario, seed=0, audit_path=audit_path,
                        device=device)
        m, b = ab.mitigated, ab.baseline
        print(f"[{scenario}] baseline {b.mean_step_time:.2f}s -> "
              f"mitigated {m.mean_step_time:.2f}s  "
              f"(+{ab.improvement:.0%} recovered; "
              f"{len(m.actuator.applied)} actions, "
              f"{m.engine.suppressed_count} suppressed, "
              f"{m.speculated} speculations, cordoned {list(m.cordoned)})")
        # the dry-run arm walked the same decision path but touched nothing
        assert b.actuator.applied == [] and b.engine.dry_run
        assert ab.improvement > 0.02, (
            f"{scenario}: mitigation recovered {ab.improvement:.1%} — "
            "the closed loop is not paying for itself")
        with open(audit_path) as f:
            entries = [json.loads(line) for line in f]
        by_type: dict[str, int] = {}
        for e in entries:
            by_type[e["type"]] = by_type.get(e["type"], 0) + 1
        print(f"[{scenario}] audit log: {len(entries)} entries {by_type}")
        assert by_type.get("decision", 0) > 0
        if not cordoned:
            cordoned = m.cordoned

    # ---- Act 2: a crashing job is restarted from the latest checkpoint
    print("== supervisor crash-restart ==")
    ckpt = CheckpointManager(os.path.join(tmp, "ckpt"), keep=2)

    def fresh_state():
        return {"w": torch.zeros((128,), dtype=torch.float32, device=device),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    template = tree.map(torch.empty_like, fresh_state())
    crashes = {"n": 0}

    def body(start_step: int, restored):
        state = restored if restored is not None else fresh_state()
        print(f"[body] starting at step {start_step} "
              f"({'restored' if restored is not None else 'fresh'})")
        for step in range(start_step, TOTAL):
            state = {"w": state["w"] - 0.01 * torch.sin(state["w"] + step),
                     "step": torch.tensor(step, dtype=torch.int32,
                                          device=device)}
            if step % 5 == 0:
                ckpt.save(step, state)
            if step == 12 and crashes["n"] == 0:
                crashes["n"] += 1
                raise RuntimeError("simulated host failure at step 12")
        return state

    sup = Supervisor(ckpt, template, max_restarts=2, device=device,
                     backoff_s=0.01, backoff_max_s=0.05, seed=0)
    final_state = sup.run(body)
    print(f"[supervisor] finished after {sup.restarts} restart(s); "
          f"failures: {sup.failures}; last backoff {sup.last_backoff_s:.3f}s")
    assert sup.restarts == 1 and int(final_state["step"]) == TOTAL - 1

    # ---- Act 3: re-mesh around the hosts the policy cordoned in Act 1
    print("== elastic re-mesh around cordoned hosts ==")
    all_hosts = [f"slave{i}" for i in range(6)]
    dropped = list(cordoned) or ["slave0"]
    alive = [h for h in all_hosts if h not in dropped]
    plan = reshard_plan(
        old_shape=(3, 16), alive_hosts=alive, all_hosts=all_hosts,
        chips_per_host=8,
    )
    print(f"[elastic] {plan.old_shape} -> {plan.new_shape}; dropped "
          f"{plan.dropped_hosts}; idle chips {plan.chips_idle}; {plan.notes}")
    assert set(plan.dropped_hosts) == set(dropped)
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
