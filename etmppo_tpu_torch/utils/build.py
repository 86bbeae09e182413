"""The port's hand-written native code: its sources (``CSRC``), one
content-keyed build for nvcc and g++ (``build``: ``<stem>_<16 hex>.so`` in
``BUILD_DIR``, keyed by the source, the headers it includes from its own
directory and the flags, built under a temporary name and moved into place
beside the compiler's report), and ``CudaKernel``, a CUDA kernel with a
plain C interface loaded with ctypes, launched on the current stream and
counted in ``launches``, with ``check_tensors`` for its tensor arguments.
A component that launches kernels lists them in its
``kernels`` (``PPOUpdate``, ``TorchEnv``, ``PhaseClock``): the trainer loads
them while it is set up, the fused loop counts them. This module imports
nothing else from the package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Sequence, Tuple

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def library_path(source: Path, flags: Sequence[str], build_dir: Path) -> Path:
    """The library's path, keyed by the source, the headers it includes from
    its own directory and the compiler's flags."""
    text = source.read_bytes()
    headers = re.findall(rb'#include "([^"]+)"', text)
    digest = hashlib.sha256(
        text + b"".join((source.parent / h.decode()).read_bytes()
                        for h in headers)
        + " ".join(flags).encode()).hexdigest()[:16]
    return build_dir / f"{source.stem}_{digest}.so"


def report_path(library: Path) -> Path:
    """Where the compiler's report of a library is kept."""
    return library.with_suffix(".log")


def build(compiler: str, flags: Sequence[str], source: Path,
          build_dir: Path) -> Path:
    """Compiles ``source`` with ``compiler`` and ``flags`` into a shared
    library unless one built from the same inputs is already there; returns
    its path."""
    out = library_path(source, flags, build_dir)
    if out.exists():
        return out
    name = Path(compiler).name
    if shutil.which(compiler) is None:
        raise RuntimeError(f"{name} not found: {source.name} cannot be built")
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        proc = subprocess.run([compiler, *flags, "-o", tmp, str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{name} failed on {source.name} "
                               f"({proc.returncode}):\n{proc.stdout}"
                               f"{proc.stderr}")
        report_path(out).write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def check_tensors(symbol: str, want: Dict[str, Tuple]) -> None:
    """Raises unless every tensor of ``want`` (name: (tensor, dtype, shape))
    has its dtype and shape, is contiguous and is on the CUDA device of the
    first."""
    for name, (x, dtype, shape) in want.items():
        if (x.dtype != dtype or tuple(x.shape) != shape
                or not x.is_contiguous()):
            raise ValueError(
                f"{symbol}: {name} must be a contiguous {dtype} tensor of "
                f"shape {shape}, got {x.dtype} {tuple(x.shape)} with strides "
                f"{x.stride()}")
    first, (ref, _, _) = next(iter(want.items()))
    for name, (x, _, _) in want.items():
        if x.device.type != "cuda" or x.device != ref.device:
            raise ValueError(
                f"{symbol}: {name} must be on the CUDA device of {first}, "
                f"got {x.device} and {ref.device}")


class CudaKernel:
    """A CUDA source built by nvcc on first use into a shared library with a
    plain C interface, loaded with ctypes. Subclasses launch it on the current
    stream and count each launch in ``launches``."""

    default_source: Path
    symbol = ""
    n_pointers = 0
    n_ints = 7

    def __init__(self, source=None, build_dir: Path = BUILD_DIR):
        self.source = Path(source or self.default_source)
        self.build_dir = Path(build_dir)
        self.launches = 0
        self._lib = None

    def library_path(self) -> Path:
        return library_path(self.source, NVCC_FLAGS, self.build_dir)

    def build(self) -> Path:
        """Compiles the source with nvcc unless it is built already, keeping
        nvcc's report (``-Xptxas -v``) beside the library. Returns the
        library's path."""
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        return build(nvcc, NVCC_FLAGS, self.source, self.build_dir)

    def resources(self) -> list:
        """Registers, spills and static shared memory of each kernel function
        in the built library, from nvcc's report: a list of dicts."""
        text = report_path(self.build()).read_text()
        found = []
        for chunk in text.split("Compiling entry function")[1:]:
            name = chunk.split("'")[1]
            nums = lambda pattern: [int(x) for x in re.findall(pattern, chunk)]
            regs = nums(r"Used (\d+) registers")
            spills = nums(r"(\d+) bytes spill (?:stores|loads)")
            smem = nums(r"(\d+) bytes smem")
            found.append(dict(function=name, registers=regs[0] if regs else 0,
                              spill_bytes=sum(spills),
                              static_smem=smem[0] if smem else 0))
        return found

    def load(self) -> None:
        """Builds the library if needed and loads it (the trainer does so
        while it is set up, before its first launch)."""
        self._function()

    def _function(self):
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            fn = getattr(lib, self.symbol)
            fn.argtypes = [ctypes.c_void_p] * self.n_pointers + [
                ctypes.c_int] * self.n_ints + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._lib = lib
        return getattr(self._lib, self.symbol)

    def _launch(self, pointers, ints, device) -> None:
        stream = torch.cuda.current_stream(device).cuda_stream
        err = self._function()(*pointers, *ints, stream)
        if err != 0:
            raise RuntimeError(
                f"{self.symbol} launch failed: CUDA error {err}")
        self.launches += 1
