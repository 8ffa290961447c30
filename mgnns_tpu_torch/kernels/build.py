"""Build the package's CUDA sources into shared libraries loaded with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/torch_ext/`` at the repository
root, named by a hash of its source and flags so a changed source is rebuilt
and an unchanged one is loaded as it is, with nvcc's log kept beside it
(``lib<name>-<hash>.log``).  Nothing is compiled at import:
:func:`load` builds on first use, and :func:`build_all` starts one ``nvcc``
per source at once.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "torch_ext")
SOURCES = ("edge_max",)
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass
class Library:
    lib: ctypes.CDLL
    log: str  # nvcc's output (ptxas register / spill report), kept beside the .so


_loaded: dict[str, Library] = {}


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
            with open(f"{tmp}.log", "w") as f:
                f.write(logs[name])
            # atomic, the log first: a concurrent build never sees half a
            # file, and a library on disk always has its log
            os.replace(f"{tmp}.log", _log_path(so))
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    for name in todo:
        so = _target(name)[1]
        with open(_log_path(so)) as f:
            _loaded[name] = Library(ctypes.CDLL(so), f.read())
    return {n: _loaded[n] for n in names}


def _log_path(so: str) -> str:
    return so[:-len(".so")] + ".log"


def load(name: str) -> ctypes.CDLL:
    return build_all((name,))[name].lib
