"""Data substrate: deterministic host-sharded synthetic pipeline."""
from .pipeline import DataConfig, HostDataLoader, Prefetcher

__all__ = ["DataConfig", "HostDataLoader", "Prefetcher"]
