"""Build and load the package's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface under ``build/`` next to this package, named by a hash of the
source and the flags (a changed source is rebuilt), and loaded with
``ctypes``.  ``compile_sources`` starts one ``nvcc`` per source, all at
once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class KernelBuild:
    """A compiled library: its path, the compiler log and the seconds the
    build took (0 and an empty log when it was already built)."""

    def __init__(self, path: str, log: str, seconds: float, lib=None):
        self.path = path
        self.log = log
        self.seconds = seconds
        self.lib = lib


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       f"{CSRC} with the CUDA toolkit")


def library_path(source: str) -> str:
    """The library's path, named by a hash of the source, the headers
    beside it (``csrc/*.cuh``) and the flags."""
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [source] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, "rb") as fh:
            digest.update(fh.read())
    tag = digest.hexdigest()[:12]
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{tag}.so")


def compile_sources(sources) -> dict[str, KernelBuild]:
    """Compile every source whose library is missing, one ``nvcc`` per
    source running in parallel.  Raises if any compile fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    builds, running = {}, {}
    for source in sources:
        so = library_path(source)
        if os.path.exists(so):
            builds[source] = KernelBuild(so, "", 0.0)
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        running[source] = (so, tmp, subprocess.Popen(
            [find_nvcc(), *NVCC_FLAGS, "-o", tmp, source],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for source, (so, tmp, proc) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {source}:\n{log}")
            continue
        os.replace(tmp, so)
        builds[source] = KernelBuild(so, log, time.perf_counter() - t0)
    if failed:
        raise RuntimeError("\n".join(failed))
    return builds


def load(source: str, symbol: str, argtypes) -> KernelBuild:
    """Build ``source`` if needed and bind its C entry point ``symbol``
    (returning a CUDA error code)."""
    build = compile_sources([source])[source]
    build.lib = ctypes.CDLL(build.path)
    fn = getattr(build.lib, symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return build
