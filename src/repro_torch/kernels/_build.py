"""Build and load the CUDA kernels: ``nvcc`` into plain C shared libraries,
bound with ``ctypes``.

Each ``csrc/<name>.cu`` becomes ``build/lib<name>-<hash>.so``; the hash
covers the sources and the flags, so an edited kernel is rebuilt and an
unchanged one is reused.  All missing libraries are compiled at once, one
``nvcc`` process per source started together.  Nothing is built at import
time: the first launch (or ``build_all``) builds.  ``-Xptxas -v``'s
register, shared-memory and spill report is kept beside each library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

from repro_torch import tracing

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
# perturbed_matmul_tc finds cuTensorMapEncodeTiled through
# cudaGetDriverEntryPoint, so no library links -lcuda
SOURCES = ("perturbed_matmul", "perturbed_matmul_tc", "mgd_update")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600

_LIBS: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA kernels "
                       "are compiled on first use and need the CUDA toolkit")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def lib_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def report_path(name: str) -> pathlib.Path:
    return lib_path(name).with_suffix(".ptxas.txt")


def build_all(names=SOURCES) -> dict:
    """Compile every library in ``names`` that is not built yet, in
    parallel; return ``{name: ptxas report}`` for all of them."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    missing = [name for name in names if not lib_path(name).is_file()]
    if missing:
        with tracing.span("kernels.build", libs=missing):
            _compile(missing)
    return {name: report_path(name).read_text()
            if report_path(name).is_file() else "" for name in names}


def _compile(names) -> None:
    """nvcc on every library in ``names`` at once; raises if any fails."""
    pending = {}
    for name in names:
        out = lib_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        pending[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    failures = []
    for name, (proc, tmp, out) in pending.items():
        try:
            log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            failures.append(f"{name}: nvcc timed out\n{log}")
            continue
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        report_path(name).write_text(log)
        os.replace(tmp, out)    # atomic: concurrent builders never see half
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        if not lib_path(name).is_file():
            build_all()
        with tracing.span("kernels.load", lib=name):
            lib = ctypes.CDLL(str(lib_path(name)))
        _LIBS[name] = lib
    return lib
