"""Build and load the port's CUDA kernels: one helper for every kernel family.

Every source is compiled with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface at first use (one ``nvcc`` per source, all
of :data:`SOURCES` started together), cached under ``build/kernels/`` at the
root of the checkout by a hash of the source and the flags, and called
through ``ctypes`` on PyTorch's current stream.  Nothing is compiled when a
module is imported; the CPU tests import every kernel module without a CUDA
toolkit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

KERNELS_DIR = Path(__file__).resolve().parent
# every CUDA source of the port, relative to this package
SOURCES = ("quant_gossip/csrc/quantize.cu", "quant_gossip/csrc/accumulate.cu",
           "flash_attention/csrc/flash_fwd.cu", "flash_attention/csrc/flash_bwd.cu",
           "rwkv6_scan/csrc/wkv6.cu", "gossip_update/csrc/gossip_update.cu")
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA "
                       "toolkit to build")


def lib_path(source: str) -> Path:
    """Where the library of ``source`` (a path in :data:`SOURCES`) is built,
    keyed by the source's bytes, the headers beside it and the flags."""
    src = KERNELS_DIR / source
    headers = b"".join(h.read_bytes() for h in sorted(src.parent.glob("*.cuh")))
    tag = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
                         ).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{tag}.so"


def build(sources: tuple[str, ...] = SOURCES) -> dict[str, tuple[Path, str]]:
    """Compile every source of ``sources`` whose library of this source and
    these flags is not built yet, one ``nvcc`` per source, all started
    together.  Returns {source: (library path, compiler output; empty when
    the library was cached)}."""
    built: dict[str, tuple[Path, str]] = {}
    running = []
    try:
        for source in sources:
            lib = lib_path(source)
            if lib.exists():
                built[source] = (lib, "")
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(KERNELS_DIR / source)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            running.append((source, lib, tmp, proc))
        for source, lib, tmp, proc in running:
            out, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {source}:\n{err}")
            os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file
            built[source] = (lib, out + err)
    finally:
        for _, _, _, proc in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return built


@functools.cache
def entry(source: str, symbol: str, argtypes: tuple):
    """The C function ``symbol`` of ``source``'s library, built (with every
    other source) on first use; it returns a ``cudaError_t``."""
    lib_file, _ = build()[source]
    fn = getattr(ctypes.CDLL(str(lib_file)), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def route(name: str, t: torch.Tensor) -> bool:
    """A dispatcher's choice: True for the kernel (CUDA tensors), False for
    the plain version (CPU tensors); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch(fn, symbol: str, device: torch.device, *args) -> None:
    """Call ``fn`` on ``device``'s current stream; raise if the launch failed."""
    with torch.cuda.device(device):
        err = fn(*args, stream(device))
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError_t {err}")
