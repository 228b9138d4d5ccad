"""Builds the CUDA sources under ``csrc/`` into shared libraries with a
plain C interface, loaded with ``ctypes``.

Each ``csrc/<name>.cu`` compiles at first use with ``nvcc`` for Hopper
(``sm_90a``) into ``build/repro_torch/lib<name>-<hash>.so`` at the root of
the checkout; the hash covers the source and the flags, so an edited
source rebuilds and an unchanged one is reused.  Nothing here runs when
the module is imported, and nothing is fetched or prebuilt.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile every named source that is not built yet, one ``nvcc`` per
    source, all started together.  Returns ``{name: compiler output}``
    (``-Xptxas -v`` reports registers, shared memory and spills) for the
    sources compiled by this call; raises if any compile fails, after
    every started compiler has exited."""
    nvcc = None
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in started.items():
        logs[name], _ = proc.communicate()
        if proc.returncode:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {n}.cu ---\n{logs[n]}" for n in failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (built on first use)."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))


def aligned16(t) -> bool:
    """Whether 16-byte copies (``cp.async``, TMA) can read ``t``: a 16-byte
    aligned base and strides (but the unit last one) of whole 16-byte
    pieces, as every view of a model activation or cache has."""
    item = t.element_size()
    return t.data_ptr() % 16 == 0 and all(s * item % 16 == 0
                                          for s in t.stride()[:-1])
