"""Time variants of B.6's and B.7's bfloat16 instances on the card.

    python tests/bf16_variants.py base bn32 bn128 ring3 occ4 tf32pv noexp nolo nopv

Each argument is one variant of ``flash_attention/csrc/flash_fwd.cu`` and
``rwkv6_scan/csrc/wkv6.cu`` (``base``: the sources as they are), built with
the port's nvcc flags (all started together), held against the plain
versions (B.6 within one bfloat16 ulp plus 2e-5, B.7 bit-equal to the
float32 kernel on the widened inputs) and timed through the wrappers
(device time under the profiler, ``chip_smoke.device_ms``) at qwen2-0.5b's
prefill (B 4, H 14 over 2 KV heads, S 512, hd 64) and rwkv6-7b's (B 4, H
64, T 256, hd 64) in bfloat16, between two timings of the built float32
kernels on the same values widened (the anchor, in turns).

B.6: ``bn32`` and ``bn128`` take K/V tiles of 32 and 128 keys (64 in the
source), ``ring3`` keeps a K/V ring of three tiles below hd 128 (two in the
source), ``occ4`` asks ptxas for four CTAs per SM
(``__launch_bounds__(128, 4)``); ``tf32pv`` takes P V as TF32 products (P
split in big and small TF32 halves, V widened, two m16n8k8 products per 8
keys) instead of P's bfloat16 high and low parts against V (two m16n8k16
products per 16 keys).  Diagnostics, whose outputs are wrong: ``noexp``
drops the softmax's exp (one MUFU per score), ``nolo`` P's low half (one
of the two P V products), ``nopv`` the P V products and their V loads
(and so P's split, which nothing then reads).
B.7 is timed as the source has it (its raw
bfloat16 chunks read in the steps) in every variant.
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
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.rwkv6_scan import kernel as wk  # noqa: E402

KERNELS = ROOT / "src/repro_torch/kernels"
SOURCES = {"flash": KERNELS / "flash_attention/csrc/flash_fwd.cu",
           "wkv6": KERNELS / "rwkv6_scan/csrc/wkv6.cu"}
OUT = ROOT / "build/bf16_variants"

TF32_PV = '''    // O += P V as TF32: P split in big and small TF32 halves, V widened
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const Frag<4> pa = c_as_a(s[kk]);
      const unsigned char* vs = skv + (2 * st + 1) * K::KVBYTES;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const int col = j * 8 + g;
        auto at = [&](int key) {
          const unsigned short x = *reinterpret_cast<const unsigned short*>(
              vs + L::template off<BN_BF>(key, col / 8) + (col % 8) * 2);
          return static_cast<uint32_t>(x) << 16;
        };
        const uint32_t bb[2] = {at(kk * 8 + 2 * c), at(kk * 8 + 2 * c + 1)};
        mma_tf32(o[j], pa.small, bb);
        mma_tf32(o[j], pa.big, bb);
      }
    }
  }
  cp_async_wait<0>();  // no copy may outlive the CTA
'''
# variant -> [(source, old, new)]; "re:" marks a regular expression
EDITS = {
    "bn32": [("flash", "constexpr int BN_BF = 64;", "constexpr int BN_BF = 32;")],
    "bn128": [("flash", "constexpr int BN_BF = 64;", "constexpr int BN_BF = 128;")],
    # diagnostics (wrong outputs): what the softmax's exp, P's low half and
    # the whole P V product cost
    "noexp": [("flash", "        const float p = exp_fast(s[j][e] - m[e / 2]);",
               "        const float p = s[j][e] - m[e / 2];")],
    "nolo": [("flash", "          mma_bf16(o[2 * jd], pl, vf[0], vf[1]);\n"
                       "          mma_bf16(o[2 * jd + 1], pl, vf[2], vf[3]);\n", ""),
             ("flash", "        mma_bf16(o[0], pl, vf[0], vf[1]);\n", "")],
    "nopv": [("flash", "re:      if constexpr \\(DT == 1\\) \\{.*?\n        \\}\n      \\}\n",
              "      (void)v_row;\n")],
    "ring3": [("flash", "static constexpr int NST = 2;",
               "static constexpr int NST = HD >= 128 ? 2 : 3;")],
    "occ4": [("flash", "__global__ void __launch_bounds__(THREADS)\n    flash_fwd_bf16_kernel",
              "__global__ void __launch_bounds__(THREADS, 4)\n    flash_fwd_bf16_kernel")],
    "tf32pv": [("flash", r"re:    // O \+= P V: P \(float32\) as its bfloat16 high.*?"
                         r"  cp_async_wait<0>\(\);  // no copy may outlive the CTA\n", TF32_PV)],
}


WRONG = {"noexp", "nolo", "nopv"}  # diagnostics whose outputs are not meant to be right


def variant_source(name: str, which: str) -> str:
    text = SOURCES[which].read_text()
    for src, old, new in EDITS.get(name, []):
        if src != which:
            continue
        if old.startswith("re:"):
            text, n = re.subn(old[3:], lambda _: new, text, count=1, flags=re.S)
            assert n == 1, (name, old)
        else:
            assert old in text, (name, old)
            text = text.replace(old, new)
    return text


def build(names) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        for which, source in SOURCES.items():
            src = OUT / f"{which}_{name}.cu"
            src.write_text(variant_source(name, which))
            procs[name, which] = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(source.parent), "-o",
                 str(src.with_suffix(".so")), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    try:
        for (name, which), proc in procs.items():
            out, err = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"variant {name} of {which} does not build:\n{err}")
            libs[name, which] = OUT / f"{which}_{name}.so"
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return libs


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("bf16_variants: no CUDA device is available", file=sys.stderr)
        return 2
    libs = build(argv)
    print(cs.nvidia_smi(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    q = randn(4, 512, 14, 64).permute(0, 2, 1, 3)
    k, v = (randn(4, 512, 2, 64).permute(0, 2, 1, 3) for _ in range(2))
    flash_want = attention_ref(q, k, v)
    r, kk, vv = (randn(4, 256, 64, 64).permute(0, 2, 1, 3) for _ in range(3))
    w = torch.rand((4, 256, 64, 64), generator=gen, device="cuda").to(torch.bfloat16).permute(
        0, 2, 1, 3)
    u = (0.5 * torch.randn((64, 64), generator=gen, device="cuda")).to(torch.bfloat16)
    wkv_in = (r, kk, vv, w, u)
    q32, k32, v32 = (x.float() for x in (q, k, v))
    wkv32 = tuple(x.float() for x in wkv_in)
    y32, s32 = wk.wkv6_scan(*wkv32)

    def anchors() -> str:
        f = cs.device_ms(lambda: fk.flash_attention_fwd(q32, k32, v32), 20,
                         cs.KERNELS["flash_attention_fwd"][2])
        g = cs.device_ms(lambda: wk.wkv6_scan(*wkv32), 20, cs.KERNELS["wkv6_scan"][2])
        return f"float32 anchors: B.6 {1e3 * f:.2f} us, B.7 {1e3 * g:.2f} us"

    print(anchors(), flush=True)
    built_entry = _build.entry
    for name in argv:
        flash_lib = ctypes.CDLL(str(libs[name, "flash"]))
        wkv_lib = ctypes.CDLL(str(libs[name, "wkv6"]))

        def entry(source, symbol, argtypes, flash_lib=flash_lib, wkv_lib=wkv_lib):
            lib = {"flash_fwd_bf16": flash_lib, "wkv6_bf16": wkv_lib}.get(symbol)
            if lib is None:
                return built_entry(source, symbol, argtypes)
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
            return fn

        fk._build.entry = wk._build.entry = entry
        try:
            out = fk.flash_attention_fwd(q, k, v)
            y, s = wk.wkv6_scan(*wkv_in)
            torch.cuda.synchronize()
            ratio = cs.bf16_ulps(out, flash_want, cs.SERVE_TOL)
            bitwise = torch.equal(s, s32) and torch.equal(y, y32.to(torch.bfloat16))
            f = cs.device_ms(lambda: fk.flash_attention_fwd(q, k, v), 20, cs.FLASH_BF16_NAMES)
            g = cs.device_ms(lambda: wk.wkv6_scan(*wkv_in), 20, cs.KERNELS["wkv6_scan"][2])
        finally:
            fk._build.entry = wk._build.entry = built_entry
        wrong = "" if ratio <= 1 else ", wrong as meant" if name in WRONG else ", WRONG"
        print(f"{name}: B.6 bf16 {1e3 * f:.2f} us (bf16 ulps {ratio:.3f}{wrong}), "
              f"B.7 bf16 {1e3 * g:.2f} us (bit-equal to float32: {bitwise})", flush=True)
    print(anchors(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
