"""Heartbeats + failure detection over a shared filesystem.

Every host runs a :class:`HeartbeatWriter` (background thread touching
``<dir>/<host>.hb`` with a timestamp each interval).  The coordinator's
:class:`FailureDetector` reads all heartbeat files and reports hosts whose
last beat is older than ``timeout`` — the trigger for the supervisor's
restart path and the elastic re-mesh planner.
"""
from __future__ import annotations

import os
import threading
import time


class HeartbeatWriter:
    def __init__(self, directory: str, host: str, interval: float = 1.0,
                 clock=time.time) -> None:
        self.path = os.path.join(directory, f"{host}.hb")
        self.interval = interval
        self.clock = clock
        os.makedirs(directory, exist_ok=True)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def beat(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write(f"{self.clock():.3f}")
        os.replace(tmp, self.path)

    def start(self) -> "HeartbeatWriter":
        self.beat()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self.beat()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def __enter__(self) -> "HeartbeatWriter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class FailureDetector:
    def __init__(self, directory: str, timeout: float = 5.0,
                 clock=time.time) -> None:
        self.directory = directory
        self.timeout = timeout
        self.clock = clock

    def last_beats(self) -> dict[str, float]:
        beats: dict[str, float] = {}
        if not os.path.isdir(self.directory):
            return beats
        for name in os.listdir(self.directory):
            if not name.endswith(".hb"):
                continue
            try:
                with open(os.path.join(self.directory, name)) as f:
                    beats[name[:-3]] = float(f.read().strip())
            except (OSError, ValueError):
                continue
        return beats

    def alive(self) -> list[str]:
        now = self.clock()
        return sorted(
            h for h, t in self.last_beats().items() if now - t <= self.timeout
        )

    def dead(self) -> list[str]:
        now = self.clock()
        return sorted(
            h for h, t in self.last_beats().items() if now - t > self.timeout
        )
