"""Serving substrate: the batched prefill/decode engine over the KV cache,
plus the launcher-side :class:`FleetAggregator` / :class:`TreeAggregator`
fan-in fabric for merged fleet-wide in-loop diagnosis (sharded per-host
telemetry → one BigRoots sweep), all wired through the
:class:`Diagnosis` facade."""
from .diagnosis import Diagnosis
from .engine import Request, ServeEngine, make_decode_step, make_prefill_step
from .fleet import AggregatorJournal, FleetAggregator, TreeAggregator

__all__ = ["AggregatorJournal", "Diagnosis", "FleetAggregator", "Request",
           "ServeEngine", "TreeAggregator", "make_decode_step",
           "make_prefill_step"]
