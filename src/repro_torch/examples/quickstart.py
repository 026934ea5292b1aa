"""Quickstart: BigRoots root-cause analysis in ~40 lines.

Simulates a 5-node Spark-like cluster running NaiveBayes (the paper's §IV-B
verification workload), injects intermittent CPU contention on one node,
and asks BigRoots *why* the stragglers happened.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

from ..anomaly import InjectionSchedule, SimCluster
from ..core import (
    BigRootsAnalyzer,
    PCCAnalyzer,
    SPARK_FEATURES,
    per_stage_table,
    render_markdown,
    summarize,
)
from ..device import resolve_device


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    device = resolve_device(ap.parse_args(argv).device)

    # 1. a cluster run with CPU contention injected on slave2
    base = SimCluster(seed=0, profile="naivebayes_large").run()
    schedule = InjectionSchedule.intermittent(
        "slave2", "cpu", base.job_duration, period=30, burst=15
    )
    result = SimCluster(seed=0, profile="naivebayes_large").run(schedule)

    # 2. offline root-cause analysis (framework + system features, Eq. 5-7)
    analyzer = BigRootsAnalyzer(SPARK_FEATURES, timelines=result.timelines,
                                device=device)
    analyses = analyzer.analyze(result.trace)

    # 3. report
    print(render_markdown(summarize(analyses),
                          title="Quickstart: who slowed us down?"))
    print(per_stage_table(analyses))

    # 4. compare against the PCC baseline (paper Eq. 8)
    found_bigroots = {c.key for sa in analyses for c in sa.root_causes}
    found_pcc = PCCAnalyzer(SPARK_FEATURES).root_cause_set(result.trace)
    tp_b = len(found_bigroots & result.truth_ag)
    tp_p = len(found_pcc & result.truth_ag)
    fp_b = len(found_bigroots - result.truth)
    fp_p = len(found_pcc - result.truth)
    print(f"\nInjected-CPU attribution — BigRoots: TP={tp_b} FP={fp_b} | "
          f"PCC: TP={tp_p} FP={fp_p}")
    assert tp_b > 0, "BigRoots should find the injected contention"
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
