"""The CUDA blockwise quantizer: build, load and launch.

Replaces the Pallas TPU kernel ``quantize_blockwise`` of
``repro/kernels/quant_gossip/kernel.py``.  The source is
``csrc/quantize.cu`` (its header note gives the bound and the design).  It
is compiled with ``nvcc`` for ``sm_90a`` into a shared library with a plain
C interface at first use, cached under ``build/kernels/`` at the root of the
checkout by a hash of the source and the flags, and called through
``ctypes`` on PyTorch's current stream.  Nothing is compiled when the module
is imported; the CPU tests import it without a CUDA toolkit.

``_pick_block`` and ``num_blocks`` are the reference's layout rules, kept
identical so that wire-byte accounting matches what the kernel emits.
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

_SRC = Path(__file__).resolve().parent / "csrc" / "quantize.cu"
_BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _pick_block(d: int, block_d: int) -> int:
    block_d = min(block_d, d)
    if d % block_d:
        block_d = d  # ragged tail: fall back to a single block per row
    return block_d


def num_blocks(d: int, block_d: int) -> int:
    """Scale blocks per row for a given layout (mirrors :func:`_pick_block`,
    so wire-byte accounting matches what the kernel actually emits)."""
    return d // _pick_block(d, block_d)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the quant_gossip CUDA kernel needs the "
                       "CUDA toolkit to build")


def build() -> tuple[Path, str]:
    """Compile ``csrc/quantize.cu`` unless a library of this source and these
    flags is already built.  Returns (library path, compiler output; empty
    when the library was cached)."""
    tag = hashlib.sha256(_SRC.read_bytes() + " ".join(NVCC_FLAGS).encode()
                         ).hexdigest()[:16]
    lib = _BUILD_DIR / f"libquant_gossip_{tag}.so"
    if lib.exists():
        return lib, ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {_SRC.name}:\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: concurrent builders never see a partial file
    return lib, proc.stdout + proc.stderr


@functools.cache
def _entry():
    lib_path, _ = build()
    fn = ctypes.CDLL(str(lib_path)).quantize_blockwise_f32
    p = ctypes.c_void_p
    ll = ctypes.c_longlong
    fn.argtypes = [p, p, ctypes.c_float, p, p, p, ll, ll, ll, p]
    fn.restype = ctypes.c_int
    return fn


def quantize_blockwise(x: torch.Tensor, u: torch.Tensor, *, qmax: float = 127.0,
                       block_d: int = 65536):
    """x, u: (K, D) float32 CUDA tensors -> (q int8 (K, D), scales f32 (K, D/block)).

    Launches the kernel on the current stream and adds one to
    ``quantize_blockwise.launches``.  Raises on anything the kernel does not
    take; it never falls back to the plain version.
    """
    if x.device.type != "cuda" or u.device != x.device:
        raise ValueError(f"quantize_blockwise kernel needs x and u on one CUDA "
                         f"device, got {x.device} and {u.device}")
    if x.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"quantize_blockwise kernel takes float32, got "
                        f"{x.dtype} and {u.dtype}")
    if x.ndim != 2 or u.shape != x.shape:
        raise ValueError(f"quantize_blockwise kernel takes x, u of one (K, D) "
                         f"shape, got {tuple(x.shape)} and {tuple(u.shape)}")
    if not (x.is_contiguous() and u.is_contiguous()):
        raise ValueError("quantize_blockwise kernel takes contiguous x and u")
    if not 0.0 < float(qmax) <= 127.0:
        raise ValueError(f"qmax must be in (0, 127] for an int8 payload, got {qmax}")
    k, d = x.shape
    block = _pick_block(d, block_d)
    n_blk = d // block
    q = torch.empty((k, d), dtype=torch.int8, device=x.device)
    scales = torch.empty((k, n_blk), dtype=torch.float32, device=x.device)
    scratch = torch.zeros((k, n_blk), dtype=torch.int32, device=x.device)
    if x.numel() == 0:
        return q, scales
    fn = _entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), u.data_ptr(), float(qmax), q.data_ptr(),
                 scales.data_ptr(), scratch.data_ptr(), k, d, block, stream)
    if err != 0:
        raise RuntimeError(f"quantize_blockwise kernel launch failed: cudaError_t {err}")
    quantize_blockwise.launches += 1
    return q, scales


# launches of the kernel since the last reset (the main path's proof of use)
quantize_blockwise.launches = 0
