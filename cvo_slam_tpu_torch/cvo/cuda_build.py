"""Build and load the port's hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by its own `nvcc` process (all started together)
into a shared library with a plain C interface, loaded with ctypes. The
build happens at first use, into the package's git-ignored build/
directory; a library is named by the hash of its source, the csrc/
headers it includes (csrc/*.cuh) and the flags, so an edited source or
header is rebuilt and an unchanged one is reused.

Nothing here runs at import time: the CPU tests import every module on a
machine with no nvcc and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
SOURCES = ("moment_flow_step.cu", "ip_suite.cu", "pair_stats.cu",
           "flow_step.cu", "align_fused.cu", "hessian_post.cu",
           "moment_step.cu")

# -fmad=false: every float operation of a kernel rounds as the same
# operation of its plain PyTorch version, so gate decisions agree bit for bit
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# what the last build did: ptxas's report per source
build_report: Dict[str, object] = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "first use and need the CUDA toolkit")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _source_closure(source: str, csrc_dir: str):
    """`source` and every file under csrc_dir it includes with quotes,
    directly or through another include, each once, in include order."""
    seen, todo = [], [source]
    while todo:
        name = todo.pop(0)
        if name in seen:
            continue
        seen.append(name)
        with open(os.path.join(csrc_dir, name), "rb") as f:
            todo.extend(m.decode() for m in _INCLUDE.findall(f.read()))
    return seen


def _so_path(source: str, csrc_dir: str = CSRC_DIR,
             build_dir: str = BUILD_DIR) -> str:
    """The library of `source`, named by the hash of the source, of every
    header it includes and of the flags: an edited header rebuilds."""
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for name in _source_closure(source, csrc_dir):
        with open(os.path.join(csrc_dir, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(build_dir, f"{stem}-{digest.hexdigest()[:12]}.so")


def build_all() -> Dict[str, str]:
    """Compile every source whose library is missing, one nvcc each, all in
    parallel. Returns {source: library path}; raises on a failed build."""
    targets = {src: _so_path(src) for src in SOURCES}
    todo = {s: p for s, p in targets.items() if not os.path.exists(p)}
    if not todo:
        return targets
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for src, so in todo.items():
        tmp = f"{so[:-3]}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True),
                      tmp, so)
    failures, ptxas = [], {}
    for src, (proc, tmp, so) in procs.items():
        out, err = proc.communicate()
        ptxas[src] = (out + err).strip()
        if proc.returncode != 0:
            failures.append(f"{src}:\n{err}")
        else:
            os.replace(tmp, so)
    build_report.update(ptxas=ptxas)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return targets


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `source`, building all sources on first use."""
    with _lock:
        if source not in _libs:
            paths = build_all()
            for src, path in paths.items():
                _libs.setdefault(src, ctypes.CDLL(path))
        return _libs[source]
