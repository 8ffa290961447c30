"""Build the package's native sources into shared libraries loaded with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/torch_ext/`` at the repository
root, named by a hash of its source and flags so a changed source is rebuilt
and an unchanged one is loaded as it is, with nvcc's log kept beside it
(``lib<name>-<hash>.log``).  Nothing is compiled at import: the first
:func:`load` of any source builds every source, and :func:`build_all` starts
one ``nvcc`` per source at once (a captured step launches K1, the BiLSTM's
kernels, the optimizer's of ``adam.cu`` and the stage marks of ``mark.cu``
alike).

The host C++ of ``mgnns_tpu_torch/csrc/<name>.cpp`` (the native
preprocessing, :mod:`mgnns_tpu_torch.native`) is built the same way by the
host compiler (:func:`load_host`), apart from the CUDA sources: a machine
with a C++ compiler and no ``nvcc`` builds it.  Its flags hold
``-march=native``, so its hash also covers what that resolves to on this
host, and a library built for another CPU is never loaded.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "torch_ext")
SOURCES = ("adam", "edge_max", "lstm", "mark")
HOST_CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
# native/Makefile's flags
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass
class Library:
    lib: ctypes.CDLL
    log: str  # the compiler's output (nvcc: ptxas register / spill report), kept beside the .so
    seconds: float = 0.0  # compile time in this process; 0 when loaded as built before


_loaded: dict[str, Library] = {}
_host_loaded: dict[str, Library | None] = {}
_host_lock = threading.Lock()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {nvcc})")
    return nvcc


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return src, os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so")


def build_all(names=SOURCES) -> dict[str, Library]:
    """Build (in parallel) and load every named source; raises on any
    compiler failure with nvcc's output."""
    todo = [n for n in names if n not in _loaded]
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in todo:
        src, so = _target(name)
        if os.path.exists(so) and os.path.exists(_log_path(so)):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, so)
    logs = {}
    failed = []
    for name, (proc, tmp, so) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{logs[name]}")
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            _install(tmp, so, logs[name])
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    for name in todo:
        so = _target(name)[1]
        with open(_log_path(so)) as f:
            _loaded[name] = Library(ctypes.CDLL(so), f.read())
    return {n: _loaded[n] for n in names}


def _install(tmp: str, so: str, log: str) -> None:
    with open(f"{tmp}.log", "w") as f:
        f.write(log)
    # atomic, the log first: a concurrent build never sees half a file, and
    # a library on disk always has its log
    os.replace(f"{tmp}.log", _log_path(so))
    os.replace(tmp, so)


def _log_path(so: str) -> str:
    return so[:-len(".so")] + ".log"


def load(name: str) -> ctypes.CDLL:
    """The library of ``name``, one of :data:`SOURCES`, built at first use
    with the others."""
    return build_all()[name].lib


def _cxx() -> str | None:
    """The host C++ compiler (``c++``, else ``g++``, on PATH), or None when
    there is none."""
    return shutil.which("c++") or shutil.which("g++")


def _run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                          timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"host C++ build failed: {' '.join(cmd)} exited with "
                           f"{proc.returncode}\n{proc.stdout}")
    return proc.stdout


def load_host(name: str) -> Library | None:
    """Build (at first use) and load ``csrc/<name>.cpp`` with the host
    compiler and :data:`CXX_FLAGS`; None when no compiler is found.  A
    compiler that fails raises with its output: a build that quietly gave
    way to the numpy path would hide the native one from every check."""
    with _host_lock:  # one build per process; other processes race by os.replace
        if name in _host_loaded:
            return _host_loaded[name]
        cxx = _cxx()
        if cxx is None:
            _host_loaded[name] = None
            return None
        src = os.path.join(HOST_CSRC_DIR, f"{name}.cpp")
        # what -march=native resolves to here: the target's ISA flags
        target = _run([cxx, "-march=native", "-Q", "--help=target"])
        with open(src, "rb") as f:
            digest = hashlib.sha256(
                f.read() + " ".join(CXX_FLAGS).encode() + target.encode()).hexdigest()
        so = os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so")
        seconds = 0.0
        if not (os.path.exists(so) and os.path.exists(_log_path(so))):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            try:
                log = _run([cxx, *CXX_FLAGS, "-o", tmp, src])
            except BaseException:
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise
            seconds = time.perf_counter() - t0
            _install(tmp, so, log)
        with open(_log_path(so)) as f:
            _host_loaded[name] = Library(ctypes.CDLL(so), f.read(), seconds)
        return _host_loaded[name]
