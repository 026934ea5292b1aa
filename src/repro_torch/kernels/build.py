"""Build and load the package's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface.  It is
compiled with ``nvcc`` for Hopper (``sm_90a``) at first use into a
shared library under ``build/`` at the repository root (git-ignored),
keyed on a hash of the source and of every shared header ``csrc/*.cuh``
(``hopper.cuh``: mbarrier, TMA and wgmma helpers) so an edit to either
rebuilds, and loaded with ``ctypes``.  Nothing but the
sources of this package goes into the build, and no PyTorch header is
included, so a build takes seconds.

:func:`build` starts one ``nvcc`` per source, all together, and waits
for them; :func:`load` builds one library if it is missing and returns
the ``ctypes`` handle (cached per process).  A failed build raises with
the compiler's output — there is no other implementation to fall back
to on a CUDA device.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

CSRC = Path(__file__).resolve().parent / "csrc"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    # src/repro_torch/kernels/build.py -> repository root
    return Path(__file__).resolve().parents[3] / "build"


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and under $CUDA_HOME, default "
        "/usr/local/cuda): the CUDA kernels cannot be built"
    )


#: Offset of the error codes the C entry points return when a TMA tensor
#: map cannot be encoded (``hopper::TMAP_ERROR`` in ``csrc/hopper.cuh``):
#: ``TMAP_ERROR + CUresult``.  CUDA runtime errors lie below it.
TMAP_ERROR = 10000


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu``'s library lives: named by a hash of the
    source, every ``csrc/*.cuh`` header and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"


def describe_error(rc: int) -> str:
    """A C entry point's non-zero return code, in words."""
    if rc >= TMAP_ERROR:
        return f"TMA tensor map not encoded: CUresult {rc - TMAP_ERROR}"
    return f"CUDA error {rc}"


def build(names: Sequence[str], *, verbose: bool = False) -> dict[str, Path]:
    """Compile every missing library of ``names`` in parallel (one
    ``nvcc`` per source); returns ``{name: path}``."""
    out = {name: library_path(name) for name in names}
    todo = {n: p for n, p in out.items() if not p.exists()}
    if not todo:
        return out
    nvcc = find_nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            tmp,
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True),
        )
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        if verbose and log:
            print(log, end="")
        os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The ``ctypes`` handle of ``csrc/<name>.cu``'s library, built at
    first use.  The caller sets ``argtypes`` on the functions it calls."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LIBS[name] = lib
    return lib
