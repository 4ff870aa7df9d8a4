"""Build and load the port's CUDA sources.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, ``_build/libscgib_<name>_<hash>.so`` (one
per hash of the source and the ``csrc/*.cuh`` headers, so an edited source
or header rebuilds and an unchanged one is reused), and loaded with
``ctypes``.  ``load`` starts one ``nvcc`` for every
source it is asked for that is not built yet, all at once, and waits for
them together.  ``logs`` keeps each build's ``-Xptxas -v`` report
(registers, shared memory and spills per kernel).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

_libs: Dict[str, ctypes.CDLL] = {}
logs: Dict[str, str] = {}


def _so_path(name: str) -> Path:
    """The library's path, keyed by the source and every header in
    ``csrc/`` (an edited header rebuilds the sources that include it)."""
    digest = hashlib.sha256()
    for path in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"libscgib_{name}_{digest.hexdigest()[:16]}.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return nvcc


def load(*names: str) -> List[ctypes.CDLL]:
    """The loaded libraries of ``csrc/<name>.cu`` for each name, building
    the missing ones in parallel first.  Raises if a build fails."""
    pending = []
    for name in names:
        if name in _libs:
            continue
        so = _so_path(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{name}.cu")]
        pending.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failures = []
    for name, so, tmp, proc in pending:
        out, err = proc.communicate()
        logs[name] = err
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {name}.cu ({proc.returncode}):"
                            f"\n{out}\n{err}")
        else:
            os.replace(tmp, so)
    if failures:
        raise RuntimeError("\n".join(failures))
    for name in names:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_so_path(name)))
    return [_libs[name] for name in names]
