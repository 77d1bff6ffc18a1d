"""Time variants of the grouped masked quantizer (B.4) on the card.

    python tests/b4_variants.py 512,4,16 512,4,16,p 512,4,16,n 256,4,16 ...

Each argument is one variant of ``quant_gossip/csrc/masked_grouped.cu``:
``threads,unroll,cluster`` set kQThreads, kUnroll and kCluster (kTile and
kMinShare follow), and optional letters change it further: ``p`` gives
every segment a cluster of its own (no packing of short segments), ``n``
drops the cluster barrier (each CTA quantizes with its own share's maximum:
wrong payloads, the barrier's cost), ``f`` multiplies by the scale where
the kernel divides (wrong payloads, the division's cost).  Every variant is
built with the port's nvcc flags (all started together), checked against
the plain version, and timed through the grouped wrapper at the fmnist
MLP's and the CNN's leaves (K = 10, masks all ones and every other row):
device time of every device entry per call under the profiler
(``chip_smoke.window_device_ms``), the MLP's widest leaf alone (live and
masked), its narrowest alone, and the grouped B.5 of the MLP as a yardstick.
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
from repro_torch.kernels.quant_gossip import kernel as qk  # noqa: E402
from repro_torch.kernels.quant_gossip import ref as qref  # noqa: E402
from repro_torch.models import cnn_init, mlp_init  # noqa: E402

SOURCE = ROOT / "src/repro_torch/kernels/quant_gossip/csrc/masked_grouped.cu"
OUT = ROOT / "build/b4_variants"
EDITS = {
    "p": ("return block <= kMinShare;", "return false;"),
    "n": ("  if (n_act > 1) {\n    cluster.sync();", "  if (false) {\n    cluster.sync();"),
    "f": ("floorf(__fadd_rn(__fdiv_rn(x, scale), u))", "floorf(__fadd_rn(__fmul_rn(x, scale), u))"),
}


def variant_source(threads: int, unroll: int, cluster: int, flags: str) -> str:
    text = SOURCE.read_text()
    for name, value in (("kQThreads", threads), ("kUnroll", unroll), ("kCluster", cluster)):
        text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", text)
        assert n == 1, name
    for flag in flags:
        old, new = EDITS[flag]
        assert old in text, flag
        text = text.replace(old, new)
        if flag == "n":
            text = text.replace("if (n_act > 1) cluster_wait();", "if (false) cluster_wait();")
    return text


def build(variants) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for v in variants:
        src = OUT / ("v_%d_%d_%d%s.cu" % v)
        src.write_text(variant_source(*v))
        procs[v] = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                                     str(src.with_suffix(".so")), str(src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for v, proc in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {v} does not build:\n{err}")
        libs[v] = (OUT / ("v_%d_%d_%d%s.so" % v), re.findall(r"Used (\d+) registers", out + err))
    return libs


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("b4_variants: no CUDA device is available", file=sys.stderr)
        return 2
    variants = []
    for arg in argv:
        t, u, c, *flags = arg.split(",")
        variants.append((int(t), int(u), int(c), "".join(flags)))
    libs = build(variants)
    print(cs.nvidia_smi(), flush=True)
    g = torch.Generator().manual_seed(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    groups = {}
    for name, init in (("mlp", mlp_init), ("cnn", cnn_init)):
        dims = [d for _, d in cs.leaf_dims(init(g))]
        groups[name] = ([torch.randn((10, d), generator=gen, device="cuda") for d in dims],
                        [torch.rand((10, d), generator=gen, device="cuda") for d in dims])
    masks = {"ones": torch.ones(10, device="cuda"), "zeros": torch.zeros(10, device="cuda"),
             "mixed": (torch.arange(10, device="cuda") % 2).float()}
    built_entry = _build.entry
    for v in variants:
        lib = ctypes.CDLL(str(libs[v][0]))

        def entry(source, symbol, argtypes, lib=lib):
            if "grouped" not in symbol:
                return built_entry(source, symbol, argtypes)
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
            return fn

        _build.entry = entry
        qk.MIN_SHARE = 0 if "p" in v[3] else 4 * v[0] * v[1]
        qk.CLUSTER_SIZE = v[2]
        cases = [(f"{g}/{m}", xs, us, masks[m]) for g, (xs, us) in groups.items()
                 for m in ("ones", "mixed")]
        xs, us = groups["mlp"]
        wide = max(range(len(xs)), key=lambda i: xs[i].numel())
        narrow = min(range(len(xs)), key=lambda i: xs[i].numel())
        cases += [("mlp widest", [xs[wide]], [us[wide]], masks["ones"]),
                  ("mlp widest masked", [xs[wide]], [us[wide]], masks["zeros"]),
                  ("mlp narrowest", [xs[narrow]], [us[narrow]], masks["ones"])]
        row = []
        for tag, xs, us, m in cases:
            got = qk.masked_quantize_blockwise_grouped(xs, us, m)
            want = qref.masked_quantize_blockwise_grouped_ref(xs, us, m)
            ok = all(torch.equal(a, b) for p, q in zip(got, want) for a, b in zip(p, q))
            dev = cs.window_device_ms(
                lambda: qk.masked_quantize_blockwise_grouped(xs, us, m), 50)
            row.append(f"{tag} {1e3 * dev:.2f}" + ("" if ok else " (wrong)"))
        xs, us = groups["mlp"]
        pay = qk.masked_quantize_blockwise_grouped(xs, us, masks["ones"])
        accs, w = [x.clone() for x in xs], torch.full((10,), 0.5, device="cuda")
        dev = cs.window_device_ms(
            lambda: qk.masked_dequant_accumulate_grouped_(accs, pay, w, masks["ones"]), 50)
        row.append(f"B.5 mlp {1e3 * dev:.2f}")
        print(f"threads {v[0]} unroll {v[1]} cluster {v[2]} {v[3] or '-'} (registers "
              f"{'/'.join(libs[v][1])}), device us: " + " | ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
