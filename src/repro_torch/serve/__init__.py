"""Launcher-side :class:`FleetAggregator` / :class:`TreeAggregator`
fan-in fabric for merged fleet-wide in-loop diagnosis (sharded per-host
telemetry → one BigRoots sweep), wired through the :class:`Diagnosis`
facade."""
from .diagnosis import Diagnosis
from .fleet import AggregatorJournal, FleetAggregator, TreeAggregator

__all__ = ["AggregatorJournal", "Diagnosis", "FleetAggregator",
           "TreeAggregator"]
