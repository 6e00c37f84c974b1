"""Build the CUDA kernels with ``nvcc`` and bind them through ``ctypes``.

Each source ``csrc/<name>.cu`` exposes a plain C entry point and compiles
into its own shared library for ``sm_90a``.  The library name carries a hash
of the source, of the headers in ``csrc/`` and of the flags, so an edited
source or header is rebuilt and a stale library is never loaded.  Building
happens at first use (``load``), or for every kernel at once with
:func:`build`, which starts one ``nvcc`` per source, all together.  Libraries go to ``src/repro_torch/_build/``, which
``.gitignore`` lists; ``REPRO_TORCH_BUILD_DIR`` moves them.

Nothing here runs at import: the CPU tests import every module, and a
machine without the CUDA toolkit never reaches ``nvcc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["SOURCES", "BuildReport", "build", "build_dir", "load", "nvcc_command"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
SOURCES = ("assign_min", "weighted_segsum", "flash_attention", "pairwise_sqdist", "min_dist_update")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass(frozen=True)
class BuildReport:
    name: str
    library: Path
    seconds: float          # 0.0 when the library was already built
    ptxas: tuple[str, ...]  # register / shared-memory / spill / warning lines of -Xptxas -v


def build_dir() -> Path:
    return Path(os.environ.get("REPRO_TORCH_BUILD_DIR", _PKG / "_build"))


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of repro_torch are "
            "built from csrc/ at first use on a machine with the CUDA toolkit"
        )
    return found


def _library(name: str) -> Path:
    """The library path for ``csrc/<name>.cu``: its name hashes the source,
    every header of ``csrc/`` (a source may include any of them) and the
    flags, so an edited header rebuilds the sources that share it."""
    h = hashlib.blake2b(digest_size=8)
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()}.so"


def nvcc_command(name: str, out: Path) -> list[str]:
    """The ``nvcc`` command line that builds ``csrc/<name>.cu`` into ``out``."""
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names=SOURCES) -> dict[str, BuildReport]:
    """Build every named library that is missing, one ``nvcc`` per source,
    all started together.  Raises with the compiler's output on failure."""
    build_dir().mkdir(parents=True, exist_ok=True)
    reports, jobs = {}, {}
    for name in names:
        lib = _library(name)
        if lib.exists():
            reports[name] = BuildReport(name, lib, 0.0, ())
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            nvcc_command(name, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        jobs[name] = (proc, lib, tmp, time.perf_counter())
    failed = []
    for name, (proc, lib, tmp, t0) in jobs.items():
        out, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{name}.cu (rc {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
        ptxas = tuple(
            l.strip() for l in out.splitlines()
            if "registers" in l or "spill" in l or "Compiling entry" in l or "warning" in l
        )
        reports[name] = BuildReport(name, lib, seconds, ptxas)
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    lib = _LOADED.get(name)
    if lib is None:
        path = build((name,))[name].library
        lib = ctypes.CDLL(str(path))
        _LOADED[name] = lib
    return lib
