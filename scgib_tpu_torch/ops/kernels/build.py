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
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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


def _log_path(so: Path) -> Path:
    """Where the build of library ``so`` keeps its ptxas report."""
    return so.with_name(f"{so.name}.ptxas")


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
        if so.exists() and _log_path(so).exists():
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
