"""Build and bind the CUDA kernels of ``zk_stark_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` compiles on first use, with ``nvcc`` for ``sm_90a``,
into its own shared library with a plain C interface, loaded with
``ctypes``.  The library's file name carries a hash of its sources (the
``.cu`` file, every ``.cuh`` header) and of the compiler flags, so a stale
library is never loaded.  Libraries go to ``zk_stark_tpu_torch/build/``.

Every C entry point takes its pointers and its stream as ``void*`` and
returns ``cudaGetLastError()`` after the launch; :class:`Kernel` raises when
that is not 0, because a refused launch never runs and a later
``synchronize()`` does not report it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Sequence

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD = pathlib.Path(__file__).resolve().parent.parent / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start_build(name: str) -> tuple[subprocess.Popen, pathlib.Path, pathlib.Path]:
    out = library_path(name)
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, pathlib.Path(tmp), out


def _finish_build(proc, tmp: pathlib.Path, out: pathlib.Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {out.name}:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return log


def build(names: Sequence[str]) -> dict[str, str]:
    """Compile every missing library of ``names`` in parallel (one nvcc per
    source, all started together).  Returns each new build's compiler log
    (with ``-Xptxas -v``: registers, shared memory, spills)."""
    jobs = {
        name: _start_build(name)
        for name in names
        if not library_path(name).exists()
    }
    logs = {}
    errors = []
    for name, job in jobs.items():
        try:
            logs[name] = _finish_build(*job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def load(name: str) -> ctypes.CDLL:
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


class Kernel:
    """One C entry point of one library, with its count of launches.

    ``launches`` goes up by one for every successful launch and nowhere
    else, so a run can show that it went through the kernel: here for a
    launch from Python, in ``segments.Segment`` for the launches a CUDA
    graph's replay makes (a capture records its calls without launching
    them, so it leaves the count as it was).  ``calls`` counts the calls
    from Python alone, captures included.
    """

    #: every Kernel made, in order (what a capture reads the counts of)
    instances: list["Kernel"] = []

    def __init__(self, library: str, symbol: str, argtypes: Sequence, replaces: str,
                 name: str | None = None):
        self.library = library
        self.symbol = symbol
        #: the key of its count in a report (the symbol, unless two counters
        #: share one entry point)
        self.name = name or symbol
        self.argtypes = list(argtypes)
        #: the TPU kernel this one stands in for (file:line in the JAX package)
        self.replaces = replaces
        self.launches = 0
        self.calls = 0
        self._fn = None
        Kernel.instances.append(self)

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(load(self.library), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = self._fn(*args)
        if rc != 0:
            raise RuntimeError(
                f"CUDA kernel {self.symbol} failed to launch: error {rc}"
            )
        self.launches += 1
        self.calls += 1


def check_cuda_tensor(t: torch.Tensor, name: str, dtype, shape=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and of
    ``shape`` where given)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def check_device(t: torch.Tensor, name: str) -> None:
    """Plain versions run only on CPU tensors; anything else that reaches a
    wrapper and is not CUDA is refused."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (the default of every
    entry point) requires a card: there is no quiet fall back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device
