"""Build and load the port's CUDA sources.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, ``_build/libscgib_<name>_<hash>.so`` (one
per hash of the source and the ``csrc/*.cuh`` headers, so an edited source
or header rebuilds and an unchanged one is reused), and loaded with
``ctypes``.  ``load`` starts one ``nvcc`` for every
source it is asked for that is not built yet, all at once, and waits for
them together.  Each build's ``-Xptxas -v`` report (registers, shared
memory and spills per kernel) is kept beside its library, so a library
built earlier still has it: ``logs`` holds the report of every library
loaded, and ``ptxas_report`` reads it kernel by kernel.

``library`` is what the kernel wrappers call: the loaded library with its
entries' argument types bound once.  ``ptr``, ``stream``, ``raise_on`` and
``on_card`` are the wrappers' ctypes plumbing: a tensor's address, the
current stream, a launch's error code raised, and which version a tensor's
device takes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

_libs: Dict[str, ctypes.CDLL] = {}
_bound: Dict[str, ctypes.CDLL] = {}      # ``library``'s, bound once
logs: Dict[str, str] = {}


def _so_path(name: str) -> Path:
    """The library's path, keyed by the source and every header in
    ``csrc/`` (an edited header rebuilds the sources that include it)."""
    digest = hashlib.sha256()
    for path in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"libscgib_{name}_{digest.hexdigest()[:16]}.so"


def _log_path(so: Path) -> Path:
    """Where the build of library ``so`` keeps its ptxas report."""
    return so.with_name(f"{so.name}.ptxas")


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return nvcc


def nvcc_command(src: Path, out: Path) -> List[str]:
    """The ``nvcc`` command that builds the library ``out`` from the CUDA
    source ``src`` (its headers beside it), with its ptxas report on
    standard error."""
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", str(out), str(src)]


def load(*names: str) -> List[ctypes.CDLL]:
    """The loaded libraries of ``csrc/<name>.cu`` for each name, building
    the missing ones in parallel first.  Raises if a build fails."""
    pending = []
    for name in names:
        if name in _libs:
            continue
        so = _so_path(name)
        if so.exists() and _log_path(so).exists():
            continue
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        pending.append((name, so, tmp, subprocess.Popen(
            nvcc_command(CSRC / f"{name}.cu", tmp), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    failures = []
    for name, so, tmp, proc in pending:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {name}.cu ({proc.returncode}):"
                            f"\n{out}\n{err}")
        else:
            # the report first: a library on disk always has one beside it
            log_tmp = tmp.with_name(f"{tmp.name}.ptxas")
            log_tmp.write_text(err)
            os.replace(log_tmp, _log_path(so))
            os.replace(tmp, so)
    if failures:
        raise RuntimeError("\n".join(failures))
    for name in names:
        if name not in _libs:
            so = _so_path(name)
            _libs[name] = ctypes.CDLL(str(so))
            logs[name] = _log_path(so).read_text()
    return [_libs[name] for name in names]


def library(name: str, bind: Callable[[ctypes.CDLL], ctypes.CDLL]
            ) -> ctypes.CDLL:
    """``load(name)``'s library, given its entries' argument and return
    types by ``bind`` the first time, and that same object after (a later
    ``load`` that makes a new one leaves it as it is)."""
    lib = _bound.get(name)
    if lib is None:
        lib = _bound[name] = bind(load(name)[0])
    return lib


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    """The tensor's device address (NULL for None)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream() -> ctypes.c_void_p:
    """The current CUDA stream, which every launch takes."""
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def raise_on(err: int, name: str):
    """Raise for a launch of ``name`` that returned CUDA error ``err``."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def on_card(name: str, x: torch.Tensor) -> bool:
    """True: ``name`` launches its kernel (CUDA tensor).  False: its plain
    version (CPU tensor).  Raises for any other device."""
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {x.device}")


def ptxas_report(name: str) -> Dict[str, Dict[str, int]]:
    """Each kernel of ``csrc/<name>.cu`` (by its mangled name):
    ``registers`` a thread and the bytes of ``spill_stores`` and
    ``spill_loads``, from the ptxas report of its build.  ``load`` the
    library first."""
    report: Dict[str, Dict[str, int]] = {}
    entry = props = None
    for line in logs[name].splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and props is not None:
            rec = report.setdefault(props, {})
            rec["spill_stores"], rec["spill_loads"] = map(int, m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            report.setdefault(entry, {})["registers"] = int(m.group(1))
    return {k: r for k, r in report.items() if "registers" in r}
