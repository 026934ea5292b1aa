"""Accuracy accounting + ROC harness (paper §IV-B, Eq. 9, Fig. 8).

The evaluation unit is a (straggler task, feature) pair:

- TP: feature affected by an injected anomaly AND identified as root cause.
- FP: feature not affected but identified.
- TN: feature not affected and not identified.
- FN: feature affected but not identified.

Note the paper's Eq. 9 prints ``FPR = FN/(FP+TN)``; the standard
``FPR = FP/(FP+TN)`` is implemented (the printed form is a typo — it would
not describe false positives at all).

The ROC sweep varies the analyzer's two thresholds over a grid (the paper's
*quantile/median* thresholds for BigRoots, *Pearson/max* for PCC) and
produces the scatter the paper integrates; AUC is computed on the upper
staircase envelope anchored at (0,0) and (1,1).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, Sequence


Pair = tuple[str, str]  # (task_id, feature)


@dataclass(frozen=True)
class ConfusionCounts:
    tp: int
    tn: int
    fp: int
    fn: int

    @property
    def tpr(self) -> float:  # recall
        d = self.tp + self.fn
        return self.tp / d if d else 0.0

    @property
    def fpr(self) -> float:
        d = self.fp + self.tn
        return self.fp / d if d else 0.0

    @property
    def acc(self) -> float:
        d = self.tp + self.tn + self.fp + self.fn
        return (self.tp + self.tn) / d if d else 0.0

    @property
    def precision(self) -> float:
        d = self.tp + self.fp
        return self.tp / d if d else 0.0


def evaluate(found: set[Pair], truth: set[Pair], universe: set[Pair]) -> ConfusionCounts:
    """Confusion counts over ``universe`` (all candidate (straggler, feature) pairs)."""
    found = found & universe
    truth = truth & universe
    tp = len(found & truth)
    fp = len(found - truth)
    fn = len(truth - found)
    tn = len(universe) - tp - fp - fn
    return ConfusionCounts(tp=tp, tn=tn, fp=fp, fn=fn)


@dataclass(frozen=True)
class RocPoint:
    fpr: float
    tpr: float
    params: tuple


def roc_sweep(
    analyze_fn: Callable[..., set[Pair]],
    truth: set[Pair],
    universe: set[Pair],
    grid: Iterable[tuple],
) -> list[RocPoint]:
    """Evaluate ``analyze_fn(*params)`` over a threshold grid → ROC points."""
    points = []
    for params in grid:
        found = analyze_fn(*params)
        c = evaluate(found, truth, universe)
        points.append(RocPoint(fpr=c.fpr, tpr=c.tpr, params=params))
    return points


def auc(points: Sequence[RocPoint]) -> float:
    """Area under the upper staircase envelope of the ROC scatter.

    Grid sweeps produce a point cloud (paper Fig. 8's 'fluctuation ... caused
    by the joint influence of the two thresholds'); the achievable operating
    curve is its upper envelope, anchored at (0,0) and (1,1).
    """
    pts = sorted({(p.fpr, p.tpr) for p in points} | {(0.0, 0.0), (1.0, 1.0)})
    # Upper envelope: best TPR at or below each FPR, monotone non-decreasing.
    env: list[tuple[float, float]] = []
    best = 0.0
    for fpr, tpr in pts:
        best = max(best, tpr)
        if env and env[-1][0] == fpr:
            env[-1] = (fpr, best)
        else:
            env.append((fpr, best))
    area = 0.0
    for (x0, y0), (x1, y1) in zip(env, env[1:]):
        area += (x1 - x0) * (y0 + y1) / 2.0
    return area


# -- score-based ROC (continuous detectors, e.g. repro_torch.core.forecast) ---
#
# The set-based API above evaluates *discrete* analyzer outputs over a
# threshold grid. A scored detector emits one real number per example, so
# its whole ROC falls out of a single ranking — no grid needed.


def score_points(
    scores: Sequence[float], labels: Sequence[int]
) -> list[RocPoint]:
    """ROC points for a scored detector: alarm when ``score >= threshold``.

    One point per distinct score value (``params=(threshold,)``), swept
    from the strictest threshold down. Ties share a threshold and move
    together, so tied positives/negatives trade off honestly instead of
    being ordered by index.
    """
    if len(scores) != len(labels):
        raise ValueError("scores and labels must have equal length")
    pos = sum(1 for y in labels if y)
    neg = len(labels) - pos
    points = []
    for thr in sorted(set(scores), reverse=True):
        tp = sum(1 for s, y in zip(scores, labels) if s >= thr and y)
        fp = sum(1 for s, y in zip(scores, labels) if s >= thr and not y)
        points.append(
            RocPoint(
                fpr=fp / neg if neg else 0.0,
                tpr=tp / pos if pos else 0.0,
                params=(thr,),
            )
        )
    return points


def score_auc(scores: Sequence[float], labels: Sequence[int]) -> float:
    """AUC of a scored detector = P(score(pos) > score(neg)), ties half.

    Computed as the Mann-Whitney U statistic via average ranks — exactly
    the trapezoid area under the proper tie-aware ROC curve, without
    building it. Degenerate inputs (empty, or all labels one class) have
    no ranking to measure and return 0.5 (chance).
    """
    if len(scores) != len(labels):
        raise ValueError("scores and labels must have equal length")
    pos = sum(1 for y in labels if y)
    neg = len(labels) - pos
    if pos == 0 or neg == 0:
        return 0.5
    order = sorted(range(len(scores)), key=lambda i: scores[i])
    ranks = [0.0] * len(scores)
    i = 0
    while i < len(order):
        j = i
        while j + 1 < len(order) and scores[order[j + 1]] == scores[order[i]]:
            j += 1
        avg = (i + j) / 2.0 + 1.0  # 1-based average rank over the tie run
        for k in range(i, j + 1):
            ranks[order[k]] = avg
        i = j + 1
    rank_pos = sum(r for r, y in zip(ranks, labels) if y)
    return (rank_pos - pos * (pos + 1) / 2.0) / (pos * neg)
