"""Build and load the port's CUDA kernels.

Each source `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into a
shared library with a plain C interface and loaded with `ctypes` (no
PyTorch headers: a build takes seconds, not minutes).  Libraries land in
`<repo>/build/kernels/`, named by a hash of the source, the shared headers
and the flags, so an edited source or header rebuilds and an unchanged one
is reused.  A failed build raises; nothing falls back to another path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("topk_mips", "flash_attention", "decode_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (needed to build the CUDA kernels)")


def library_path(name: str) -> Path:
    """The library's path, tagged by a hash of the source, the shared
    headers (`csrc/*.cuh`) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(name: str) -> dict:
    """Compile `csrc/<name>.cu` unless an up-to-date library exists.
    Returns {"path", "seconds", "ptxas"} (ptxas's register report; 0 s and
    no report for a library that was already built)."""
    out = library_path(name)
    if out.exists():
        return {"path": str(out), "seconds": 0.0, "ptxas": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"CUDA kernel build of {name} failed: nvcc "
                           f"exited {proc.returncode}\n{proc.stdout}")
    os.replace(tmp, out)
    return {"path": str(out), "seconds": time.perf_counter() - t0,
            "ptxas": proc.stdout}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
