"""Build and load the CUDA kernels of ``kernels/csrc``.

Each ``.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``.  The build
happens at first use, into ``build/repro_torch/`` at the repository root
(listed in ``.gitignore``), under a name that carries a hash of the
sources, so an edited source is rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC.parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = pathlib.Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built on this machine")


class BuiltLibrary:
    """One compiled source: the loaded library and how it was built."""

    def __init__(self, path: pathlib.Path, log: str, seconds: float):
        self.path = path
        self.log = log          # nvcc/ptxas output (registers, spills)
        self.seconds = seconds  # 0.0 when an existing build was reused
        self.lib = ctypes.CDLL(str(path))


def _digest(source: pathlib.Path) -> str:
    h = hashlib.sha256()
    for f in sorted(source.parent.glob("*.cuh")) + [source]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def output_path(source: str, csrc: pathlib.Path = CSRC) -> pathlib.Path:
    """Where the build of one source of ``csrc`` goes (another tree's
    kernel sources may be given: their builds land beside these, under
    their own hash; equal sources share one)."""
    src = pathlib.Path(csrc) / source
    return BUILD_DIR / f"{src.stem}-{_digest(src)}.so"


def start_build(source: str, csrc: pathlib.Path = CSRC):
    """Start nvcc on one source of ``csrc``; returns (process or None,
    output_path).  None means a build with the same hash already
    exists."""
    src = pathlib.Path(csrc) / source
    out = output_path(source, csrc)
    if out.exists():
        return None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out


def finish_build(proc, out: pathlib.Path, started: float) -> BuiltLibrary:
    if proc is None:
        return BuiltLibrary(out, "", 0.0)
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(out.with_suffix(f".{os.getpid()}.tmp"), out)
    return BuiltLibrary(out, log, time.perf_counter() - started)


def build_all(sources,
              csrc: pathlib.Path = CSRC) -> dict[str, BuiltLibrary]:
    """Build several sources with one nvcc each, all started together."""
    t0 = time.perf_counter()
    started = {s: start_build(s, csrc) for s in sources}
    return {s: finish_build(proc, out, t0)
            for s, (proc, out) in started.items()}
