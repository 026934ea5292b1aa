"""Anomaly-injection study (paper §IV-B condensed): inject each AG kind into
the simulated cluster, compare BigRoots vs PCC attribution, and show the
edge-detection ablation.

    PYTHONPATH=src python -m repro_torch.examples.anomaly_study [--device cpu]
"""
from __future__ import annotations

import argparse

from ..anomaly import InjectionSchedule, SimCluster
from ..core import (
    BigRootsAnalyzer,
    BigRootsThresholds,
    PCCAnalyzer,
    SPARK_FEATURES,
    found_set,
)
from ..device import resolve_device

TH = BigRootsThresholds(quantile=0.8)


def run_kind(kind: str, device, seeds=range(3)):
    rows = []
    for seed in seeds:
        base = SimCluster(seed=seed, profile="naivebayes_large").run()
        sched = InjectionSchedule.intermittent(
            "slave2", kind, base.job_duration, period=28, burst=14
        )
        res = SimCluster(seed=seed, profile="naivebayes_large").run(sched)

        def conf(found):
            stragglers = set()
            an = BigRootsAnalyzer(SPARK_FEATURES, TH, timelines=res.timelines,
                                  device=device)
            for sa in an.analyze(res.trace):
                stragglers.update(sa.straggler_ids)
            universe = {(t, f) for t in stragglers for f in SPARK_FEATURES.names}
            # TP against injected truth; FP excludes organic causes (which
            # the sim knows exactly)
            tp = len(found & res.truth_ag & universe)
            fp = len((found - res.truth) & universe)
            return tp, fp

        an_edge = BigRootsAnalyzer(SPARK_FEATURES, TH, timelines=res.timelines,
                                   device=device)
        an_noedge = BigRootsAnalyzer(SPARK_FEATURES, TH, timelines=None,
                                     device=device)
        pcc = PCCAnalyzer(SPARK_FEATURES)
        rows.append({
            "bigroots": conf(found_set(an_edge.root_causes(res.trace))),
            "no_edge": conf(found_set(an_noedge.root_causes(res.trace))),
            "pcc": conf(pcc.root_cause_set(res.trace)),
        })
    agg = {k: (sum(r[k][0] for r in rows), sum(r[k][1] for r in rows))
           for k in rows[0]}
    return agg


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    device = resolve_device(ap.parse_args(argv).device)
    print(f"{'AG kind':10s} {'BigRoots':>14s} {'no-edge':>14s} {'PCC':>14s}")
    for kind in ("cpu", "disk", "network"):
        agg = run_kind(kind, device)
        cells = "  ".join(
            f"TP={tp:3d} FP={fp:3d}" for tp, fp in
            (agg["bigroots"], agg["no_edge"], agg["pcc"])
        )
        print(f"{kind:10s} {cells}")
    print("\n(BigRoots ≥ PCC on TP with far fewer FP; removing edge detection "
          "raises FP — paper Fig. 9's effect.)")
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
