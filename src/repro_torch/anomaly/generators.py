"""Real anomaly generators (paper §IV-A): controlled resource hogs.

Faithful to the paper's designs:

- CPU AG: generate 1M random floats and loop power operations over them,
  occasionally dumping one element to disk to defeat optimization (§IV-A.1).
- I/O AG: continuously write 10^8 characters to disk in a loop (§IV-A.2).
- Network AG: continuously exchange 512-byte messages with a TCP echo server
  on the LAN (§IV-A.3).

The paper launches 8 worker processes per AG; ``workers`` defaults to 8 and
should be scaled down on small hosts.  Generators are context managers and
are safe to kill (daemon processes, explicit terminate on stop).
"""
from __future__ import annotations

import multiprocessing as mp
import os
import socket
import socketserver
import tempfile
import time


DEFAULT_WORKERS = 8


def _cpu_hog(stop_evt, dump_dir: str, n: int = 1_000_000) -> None:
    import random

    data = [random.random() for _ in range(n)]
    i = 0
    path = os.path.join(dump_dir, f"cpu_ag_{os.getpid()}.dump")
    while not stop_evt.is_set():
        # Power operations over the buffer (paper: "performs power operation
        # on each data in a loop").
        for j in range(0, n, 1):
            data[j] = data[j] ** 1.000001
            if stop_evt.is_set():
                break
        # Dump one random element to avoid the work being optimized away.
        with open(path, "w") as f:
            f.write(str(data[i % n]))
        i += 1


def _io_hog(stop_evt, dump_dir: str, nbytes: int = 100_000_000,
            chunk: int = 1_000_000) -> None:
    path = os.path.join(dump_dir, f"io_ag_{os.getpid()}.dat")
    payload = b"x" * chunk
    while not stop_evt.is_set():
        with open(path, "wb") as f:
            written = 0
            while written < nbytes and not stop_evt.is_set():
                f.write(payload)
                written += chunk
            f.flush()
            os.fsync(f.fileno())
        try:
            os.unlink(path)
        except OSError:
            pass


class _EchoHandler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        while True:
            data = self.request.recv(512)
            if not data:
                break
            self.request.sendall(data)


def _net_server(port_q) -> None:
    srv = socketserver.ThreadingTCPServer(("127.0.0.1", 0), _EchoHandler)
    srv.daemon_threads = True
    port_q.put(srv.server_address[1])
    srv.serve_forever(poll_interval=0.2)


def _net_hog(stop_evt, port: int) -> None:
    msg = b"y" * 512
    while not stop_evt.is_set():
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=2.0) as s:
                while not stop_evt.is_set():
                    s.sendall(msg)
                    s.recv(512)
        except OSError:
            time.sleep(0.1)


class _BaseGenerator:
    """Start/stop lifecycle shared by the three AGs."""

    kind: str = ""

    def __init__(self, workers: int = DEFAULT_WORKERS) -> None:
        self.workers = workers
        self._procs: list[mp.Process] = []
        self._stop = mp.Event()

    def _targets(self) -> list[tuple]:
        raise NotImplementedError

    def start(self) -> "_BaseGenerator":
        self._stop.clear()
        for target, args in self._targets():
            p = mp.Process(target=target, args=args, daemon=True)
            p.start()
            self._procs.append(p)
        return self

    def stop(self) -> None:
        self._stop.set()
        deadline = time.time() + 5.0
        for p in self._procs:
            p.join(timeout=max(deadline - time.time(), 0.1))
            if p.is_alive():
                p.terminate()
                p.join(timeout=1.0)
        self._procs.clear()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class CpuAnomalyGenerator(_BaseGenerator):
    kind = "cpu"

    def __init__(self, workers: int = DEFAULT_WORKERS, dump_dir: str | None = None,
                 n: int = 1_000_000) -> None:
        super().__init__(workers)
        self.dump_dir = dump_dir or tempfile.gettempdir()
        self.n = n

    def _targets(self):
        return [(_cpu_hog, (self._stop, self.dump_dir, self.n))] * self.workers


class IoAnomalyGenerator(_BaseGenerator):
    kind = "disk"

    def __init__(self, workers: int = DEFAULT_WORKERS, dump_dir: str | None = None,
                 nbytes: int = 100_000_000) -> None:
        super().__init__(workers)
        self.dump_dir = dump_dir or tempfile.gettempdir()
        self.nbytes = nbytes

    def _targets(self):
        return [(_io_hog, (self._stop, self.dump_dir, self.nbytes))] * self.workers


class NetworkAnomalyGenerator(_BaseGenerator):
    kind = "network"

    def __init__(self, workers: int = DEFAULT_WORKERS) -> None:
        super().__init__(workers)
        self._server: mp.Process | None = None
        self._port: int | None = None

    def start(self):
        q: mp.Queue = mp.Queue()
        self._server = mp.Process(target=_net_server, args=(q,), daemon=True)
        self._server.start()
        self._port = q.get(timeout=10.0)
        self._stop.clear()
        for _ in range(self.workers):
            p = mp.Process(target=_net_hog, args=(self._stop, self._port), daemon=True)
            p.start()
            self._procs.append(p)
        return self

    def stop(self) -> None:
        super().stop()
        if self._server is not None:
            self._server.terminate()
            self._server.join(timeout=2.0)
            self._server = None


GENERATORS = {
    "cpu": CpuAnomalyGenerator,
    "disk": IoAnomalyGenerator,
    "network": NetworkAnomalyGenerator,
}
