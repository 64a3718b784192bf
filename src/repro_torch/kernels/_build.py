"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``.  The
library lands in ``build/repro_torch/`` at the repository root, named by a
hash of its source and of the shared headers (``csrc/*.cuh``), so an edited
source or header rebuilds and an unchanged one is
reused; what ``ptxas -v`` said of each kernel (registers, shared memory,
spills) is kept beside it.  Nothing is built at import: the first launch
builds.  A failed build raises.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import ContextManager, Dict, List

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives: named by a hash
    of the source, the headers in ``csrc/`` it may include, and the flags."""
    text = (CSRC / source).read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        text += header.read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its library is already built."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Compile to a private name and rename: a concurrent build never sees a
    # half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed on {source} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    out.with_suffix(".log").write_text(proc.stderr)
    os.replace(tmp, out)
    return out


def ptxas_report(source: str) -> List[str]:
    """``ptxas -v``'s report for the built ``csrc/<source>``, one line per
    kernel: its name (demangled where ``c++filt`` exists), then registers,
    static shared memory, stack and spills, and any warning."""
    log = library_path(source).with_suffix(".log").read_text()
    kernels: List[List[str]] = []
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            kernels.append([entry.group(1)])
        elif kernels and ("Used" in line or "spill" in line or "warning" in line):
            kernels[-1].append(line.split(":", 1)[-1].strip() if "info" in line else line.strip())
    filt = shutil.which("c++filt")
    if filt and kernels:
        names = subprocess.run([filt], input="\n".join(k[0] for k in kernels),
                               capture_output=True, text=True).stdout.splitlines()
        for k, name in zip(kernels, names):
            k[0] = name.replace("(anonymous namespace)::", "")
    return ["; ".join(k) for k in kernels]


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use."""
    if source not in _loaded:
        _loaded[source] = ctypes.CDLL(str(build(source)))
    return _loaded[source]


def on_device(device: torch.device) -> ContextManager:
    """``torch.cuda.device(device)``, or nothing to do where ``device`` is
    already current: a launch goes to the current device, and switching
    costs host time on every call."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
