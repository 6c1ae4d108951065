"""Build the CUDA kernels at first use and bind them with ``ctypes``.

Each source under ``csrc/`` compiles on its own, with ``nvcc -gencode
arch=compute_90a,code=sm_90a``, into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds).  Libraries go to
``build/kernels/`` at the repository root, named by a hash of the source,
the shared headers (``csrc/*.cuh``) and the flags, so an edited source or
header rebuilds and an unchanged one loads the library already there.  ``build_all`` starts one ``nvcc`` per source
together and waits for all of them; the first ``load`` that has to build
builds every source at once.

Nothing here runs at import: ``nvcc`` is only called when a kernel is
first launched or ``build_all`` is called, so the modules import on a
machine without a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "-lineinfo"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOG: Dict[str, str] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """``nvcc`` of the toolkit PyTorch finds: ``$CUDA_HOME``, else the
    ``nvcc`` on ``PATH``, else ``/usr/local/cuda``."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}: set CUDA_HOME")
    return str(nvcc)


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _command(name: str, out: Path) -> list:
    return ([nvcc_path()] + ARCH_FLAGS + NVCC_FLAGS
            + ["-o", str(out), str(CSRC / f"{name}.cu")])


def build_all(names: Iterable[str]) -> float:
    """Compile every named source that has no current library, one ``nvcc``
    process each, all at once.  Returns the wall seconds; raises with the
    compiler's output if any build fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        _LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) from the build of ``name``'s current library, in this process
    or an earlier one."""
    if name not in _LOG:
        log = _target(name).with_suffix(".log")
        return log.read_text() if log.exists() else ""
    return _LOG[name]


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` at its current source is
    (or will be) built."""
    return _target(name)


def load(name: str) -> ctypes.CDLL:
    """The library for ``csrc/<name>.cu``, built on first use.  A build
    compiles every source under ``csrc/`` that has no current library
    (``build_all``), so a process that launches several kernels pays one
    parallel build, not one build a kernel in turn."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if not _target(name).exists():
                build_all(sorted(p.stem for p in CSRC.glob("*.cu")))
            lib = ctypes.CDLL(str(_target(name)))
            _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def launch(what: str, device: torch.device, fn, *args) -> None:
    """Call the ctypes launcher ``fn(*args)`` with ``device`` (the input's
    card) as the CUDA runtime's current device, then ``check`` its error
    code.  The libraries read the current device: ``cudaFuncSetAttribute``
    (the flash launch and the GEMM in ``attn_common.cuh``, the STFT) applies
    to it, ``henc_freq`` sizes its resident grid from ``cudaGetDevice``, and
    every ``<<<>>>`` launch runs on it, so without this a tensor on
    ``cuda:1`` would be launched on whichever card is current."""
    with torch.cuda.device(device):
        err = fn(*args)
    check(err, what)


def check_no_grad(what: str, *tensors) -> None:
    """Raise if autograd would record through a kernel: no kernel has a
    backward (none of the JAX package's Pallas kernels has one either)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: a kernel input requires grad, and the "
                           "kernel has no backward; run it under "
                           "torch.no_grad() or take the per-op path")


def f32(t, device, what: str):
    """A weight as a contiguous f32 tensor on ``device`` (no autograd)."""
    if t.device != device:
        raise ValueError(f"{what}: a weight is on {t.device}, x on {device}")
    return t.detach().float().contiguous()
