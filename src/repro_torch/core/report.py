"""Human-readable root-cause reports (the paper's Table VI output format).

Groups findings per feature / node / stage and attaches the schema's
optimization guidance — the paper's stated purpose is *actionable* diagnosis
("if most stragglers are due to poor data locality, the programmer should
optimize the data layout", §I).
"""
from __future__ import annotations

from collections import Counter, defaultdict
from dataclasses import dataclass, field

from .analyzer import RootCause, StageAnalysis


@dataclass
class TraceSummary:
    num_stages: int = 0
    num_tasks: int = 0
    num_stragglers: int = 0
    causes_by_feature: Counter = field(default_factory=Counter)
    causes_by_node: Counter = field(default_factory=Counter)
    unattributed_stragglers: int = 0
    guidance: dict[str, str] = field(default_factory=dict)

    @property
    def num_causes(self) -> int:
        return sum(self.causes_by_feature.values())


def summarize(analyses: list[StageAnalysis]) -> TraceSummary:
    s = TraceSummary()
    for sa in analyses:
        s.num_stages += 1
        s.num_tasks += sa.num_tasks
        s.num_stragglers += len(sa.straggler_ids)
        attributed: set[str] = set()
        for c in sa.root_causes:
            s.causes_by_feature[c.feature] += 1
            s.causes_by_node[c.node] += 1
            if c.guidance:
                s.guidance.setdefault(c.feature, c.guidance)
            attributed.add(c.task_id)
        s.unattributed_stragglers += sum(
            1 for tid in sa.straggler_ids if tid not in attributed
        )
    return s


def render_markdown(summary: TraceSummary, title: str = "BigRoots root-cause report") -> str:
    lines = [f"# {title}", ""]
    lines.append(
        f"Analyzed {summary.num_tasks} tasks across {summary.num_stages} stages; "
        f"{summary.num_stragglers} stragglers "
        f"({summary.num_causes} root-cause findings, "
        f"{summary.unattributed_stragglers} stragglers unattributed)."
    )
    lines.append("")
    if summary.causes_by_feature:
        lines.append("| root-cause feature | # findings | suggested optimization |")
        lines.append("|---|---|---|")
        for feat, cnt in summary.causes_by_feature.most_common():
            lines.append(f"| {feat} | {cnt} | {summary.guidance.get(feat, '')} |")
        lines.append("")
    if summary.causes_by_node:
        lines.append("Findings per node: " + ", ".join(
            f"{n}={c}" for n, c in summary.causes_by_node.most_common()
        ))
        lines.append("")
    return "\n".join(lines)


def per_stage_table(analyses: list[StageAnalysis]) -> str:
    """Compact per-stage summary, paper-Table-VI shaped."""
    by_feature: dict[str, Counter] = defaultdict(Counter)
    rows = []
    for sa in analyses:
        feats = Counter(c.feature for c in sa.root_causes)
        by_feature[sa.stage_id] = feats
        cause_str = ", ".join(f"{f} ({c})" for f, c in feats.most_common()) or "-"
        rows.append(
            f"| {sa.stage_id} | {cause_str} | {len(sa.straggler_ids)} |"
        )
    header = "| stage | BigRoots result | # stragglers |\n|---|---|---|"
    return header + "\n" + "\n".join(rows)
