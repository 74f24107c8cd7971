"""Build and load the port's CUDA kernels, and count their launches.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface.  It is
compiled by ``nvcc`` for ``sm_90a`` into a shared library at first use and
loaded with ``ctypes``; nothing is built when a module is imported.  The
library lands in ``build/`` beside this file (listed in ``.gitignore``),
named by a hash of its source, the shared headers ``csrc/*.cuh`` and the
flags, so an edited source or header is rebuilt and an unchanged one is
loaded again.  A build holds an exclusive ``flock`` on ``build/<name>.lock``
(released by the kernel if its process dies), so that the ranks of a
fleet started on a machine with nothing built compile each kernel once
and load it after.

``LAUNCHES`` counts, per kernel, the launches its wrapper made: a wrapper
adds one where it launches its kernel and nowhere else, so a run can show
that it went through the kernels.  :func:`load` records a
``repro_torch.kernel_load`` span (``kernel``, ``built``) the first time it
loads a library, so a process shows whether it paid ``nvcc`` or only
loaded a library.  The kernels are forward-only:
:func:`refuse_grad` is every wrapper's guard against an input that would
need a gradient through one.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch import obs

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

LAUNCHES: dict[str, int] = {}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def refuse_grad(name: str, **inputs: torch.Tensor) -> None:
    """Raise if autograd would need a gradient through kernel ``name``.

    A kernel fills fresh buffers that carry no autograd history, so an
    input that requires grad would lose its gradient silently on the card.
    The guard runs on every device, so the plain version on the CPU
    refuses alike.  Callers detach what the kernel only selects from (as
    ``ops.gate_threshold`` does) or run under ``torch.no_grad()``.
    """
    if not torch.is_grad_enabled():
        return
    live = [k for k, x in inputs.items() if x.requires_grad]
    if live:
        raise ValueError(f"{name}: the kernel is forward-only, but {live} "
                         "require grad; detach them or run under "
                         "torch.no_grad()")


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``CUDA_HOME`` or
    ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH, in CUDA_HOME or in "
                           "/usr/local/cuda; the CUDA kernels need it")
    return path


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library lands: named by a hash of its source,
    every shared header under ``CSRC`` and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(name: str, verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built (by
    this process or another: the build waits for another's to end)."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        return _compile(name, out, verbose)


def _compile(name: str, out: Path, verbose: bool) -> Path:
    # Build into a temporary name and rename: concurrent builders never
    # load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    if verbose:
        print(proc.stderr.strip())
    os.replace(tmp, out)
    return out


def build_all(verbose: bool = False) -> dict[str, Path]:
    """Build every kernel under ``csrc/``, one ``nvcc`` per source, all
    started together."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        futures = {n: pool.submit(build, n, verbose) for n in names}
        return {n: f.result() for n, f in futures.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if need be."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            # built: no library was there, so this process compiled it or
            # waited for another's build of it.
            built = not library_path(name).exists()
            with obs.span("repro_torch.kernel_load", kernel=name,
                          built=built):
                lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib
