"""Time variants of the WKV6 kernel (B.7) on the card.

    python tests/wkv6_variants.py base a j d f e b c 2 2b w [--sass DIR]

Each argument is one variant of ``rwkv6_scan/csrc/wkv6.cu``, named by the
letters of the edits it makes (``base``: none).  At hd 64 (8 x 4 tiles of
S per thread, 128 threads, reduce-scatter over 4 steps): ``a`` takes 4 x 4
tiles (256 threads), ``j`` 8 x 2 tiles (256 threads), ``d`` 8 x 8 tiles (64
threads), ``f`` 16 x 4 tiles (64 threads), ``e`` stages chunks of 16 steps
instead of 32, ``b`` reduces over 2 steps at a time and ``c`` over 8
(letters combine: ``2b``); ``2`` unrolls the loop over batches of steps
twice (the source does not unroll it); ``w`` copies only the first
chunk and computes every later chunk on it (the staging's cost: wrong
outputs).  Every variant is built with the port's nvcc flags (all started
together), checked against the plain version where its outputs are meant
to be right, and timed through the wrapper (device time under the
profiler, ``chip_smoke.device_ms``) at rwkv6-7b's prefill (B 4, H 64, T
256, hd 64), at B 2 and 8 of the same (one and up to three CTAs per SM:
whether a CTA's own latency or the SM's throughput sets the time), and at
hd 16 (B 4, H 256), and at one step from a given state.  ``--sass DIR``
writes each variant's SASS there.
Needs a CUDA device and nvcc; writes the variants under build/.
"""

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.rwkv6_scan import kernel as wk  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref  # noqa: E402

SOURCE = ROOT / "src/repro_torch/kernels/rwkv6_scan/csrc/wkv6.cu"
OUT = ROOT / "build/wkv6_variants"
SHAPE64 = "static constexpr int R = 8, J = 4, C = 32, SB = 4;"
# letters that change hd 64's shape: field -> value (they combine)
SHAPES64 = {"a": ("R", 4), "j": ("J", 2), "d": ("J", 8), "f": ("R", 16), "e": ("C", 16),
            "b": ("SB", 2), "c": ("SB", 8)}
EDITS = {
    "2": [("#pragma unroll 1\n    for (; c + SB <= n;", "#pragma unroll 2\n    for (; c + SB <= n;")],
    "w": [("if (tid == 0 && ch + 1 < n_chunks)\n        tma_chunk", "if (false)\n        tma_chunk"),
          ("mbar_wait(&bar[nb], static_cast<unsigned>((ch >> 1) & 1));",
           "if (ch == 0) mbar_wait(&bar[nb], 0u);")],
}
WRONG = set("w")  # variants whose outputs are not meant to be right
SHAPES = [("prefill B 4", 4, 64, 256, 64), ("B 2", 2, 64, 256, 64), ("B 8", 8, 64, 256, 64),
          ("hd 16", 4, 256, 256, 16), ("T 1 from a state", 4, 64, 1, 64)]


def variant_source(name: str) -> str:
    text = SOURCE.read_text()
    shape = dict(R=8, J=4, C=32, SB=4)
    for flag in "" if name == "base" else name:
        if flag in SHAPES64:
            field, value = SHAPES64[flag]
            shape[field] = value
            continue
        for old, new in EDITS[flag]:
            assert old in text, (flag, old)
            text = text.replace(old, new)
    assert SHAPE64 in text
    return text.replace(SHAPE64, "static constexpr int " + ", ".join(
        f"{k} = {v}" for k, v in shape.items()) + ";")


def build(names) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = OUT / f"wkv6_{name}.cu"
        src.write_text(variant_source(name))
        procs[name] = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                                        str(src.with_suffix(".so")), str(src)],
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    try:
        for name, proc in procs.items():
            out, err = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"variant {name} does not build:\n{err}")
            libs[name] = (OUT / f"wkv6_{name}.so",
                          re.findall(r"Used (\d+) registers", out + err))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return libs


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("wkv6_variants: no CUDA device is available", file=sys.stderr)
        return 2
    sass = None
    if "--sass" in argv:
        i = argv.index("--sass")
        sass = Path(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    libs = build(argv)
    print(cs.nvidia_smi(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {}
    for tag, b, h, t, hd in SHAPES:
        r, k, v = (torch.randn((b, t, h, hd), generator=gen, device="cuda").permute(0, 2, 1, 3)
                   for _ in range(3))
        w = torch.rand((b, t, h, hd), generator=gen, device="cuda").permute(0, 2, 1, 3)
        u = 0.5 * torch.randn((h, hd), generator=gen, device="cuda")
        s0 = torch.randn((b, h, hd, hd), generator=gen, device="cuda") if t == 1 else None
        inputs[tag] = (r, k, v, w, u, s0, wkv6_ref(r, k, v, w, u, s0))
    built_entry = _build.entry
    for name in argv:
        lib = ctypes.CDLL(str(libs[name][0]))

        def entry(source, symbol, argtypes, lib=lib):
            if symbol != "wkv6_f32":
                return built_entry(source, symbol, argtypes)
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
            return fn

        wk._build.entry = entry
        row = []
        for tag, (r, k, v, w, u, s0, (y_p, s_p)) in inputs.items():
            y, s = wk.wkv6_scan(r, k, v, w, u, s0)
            torch.cuda.synchronize()
            ok = all(torch.allclose(a, b, rtol=cs.SERVE_TOL, atol=cs.SERVE_TOL * float(b.abs().max()))
                     for a, b in ((y, y_p), (s, s_p)))
            dev = cs.device_ms(lambda: wk.wkv6_scan(r, k, v, w, u, s0), 20,
                               cs.KERNELS["wkv6_scan"][2])
            note = "" if ok else (" (wrong, as meant)" if set(name) & WRONG else " (WRONG)")
            row.append(f"{tag} {1e3 * dev:.2f}{note}")
        print(f"{name} (registers {'/'.join(libs[name][1])}), device us: " + " | ".join(row),
              flush=True)
        if sass is not None:
            sass.mkdir(parents=True, exist_ok=True)
            dump = subprocess.run([cs.cuobjdump(), "-sass", str(libs[name][0])],
                                  capture_output=True, text=True, timeout=300, check=True).stdout
            (sass / f"wkv6_{name}.sass").write_text(dump)
    wk._build.entry = built_entry
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
