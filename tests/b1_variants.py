"""Probe the fixed cost of a node-stacked gossip-update launch (B.1) on the card.

    python tests/b1_variants.py base e c o k [--parent ROOT]

Each argument is one variant of ``gossip_update/csrc/gossip_update.cu``,
named by the letters of the edits it makes (``base``: none): ``e`` returns
as soon as a CTA has found its leaf (the launch with its leaf table and
nothing else: wrong outputs); ``c`` stores u_i where out_i = sum_j W_ij u_j
belongs (no sum over the nodes, W still staged: wrong outputs); ``o``
issues the first pass's loads of theta and g before W and s are staged
(the two memory latencies overlapped; the kernel stages W first); ``k``
compiles K = 10 exactly (W's row stride and the unrolled loops at 10, not
16).  ``--parent ROOT`` adds ``parent``: the one-leaf stacked kernel of
the checkout at ROOT (e.g. ``git archive`` of the parent commit unpacked
under build/), called once per leaf.  Every variant is built with the
port's nvcc flags (all started together), checked against the built
kernel where its outputs are meant to be right, and timed at K = 10 (the
fmnist MLP's W and leaves): device time of every device entry of a call
under the profiler (``chip_smoke.window_device_ms``) for the 10-column
leaf alone, the 100,352-column leaf alone, and the MLP's 6 leaves (one
grouped call; the parent: 6 calls).  Prints ptxas's registers per variant.
Needs a CUDA device and nvcc; writes the variants under build/.
"""

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch.graphs import build_graph, metropolis_weights  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.gossip_update import kernel as gk  # noqa: E402

SOURCE = ROOT / "src/repro_torch/kernels/gossip_update/csrc/gossip_update.cu"
PARENT_SOURCE = "src/repro_torch/kernels/gossip_update/csrc/gossip_update.cu"
OUT = ROOT / "build/b1_variants"
DECLS = """  const long long cv = c0 + static_cast<long long>(threadIdx.x) * V;
  const long long c1 = c0 + threadIdx.x;
  float th[KMAX][V], gr[KMAX][V];
"""
C0 = "  const long long c0 = (cta - L.cta_begin) * kCols;\n"
FIRST_LOADS = """  if (V > 1 && L.vec) {
    if (cv < L.d) load_cols<T, KMAX, V, V>(L, k, cv, th, gr);
  } else if (c1 < L.d) {
    load_cols<T, KMAX, V, 1>(L, k, c1, th, gr);
  }
"""
EDITS = {
    "e": [("  const StackedLeaf<T>& L = t.leaf[l];\n",
           "  const StackedLeaf<T>& L = t.leaf[l];\n  if (L.d > 0) return;\n")],
    "c": [("          a0[v] = __fmaf_rn(w0[j], th[j][v], a0[v]);\n"
           "          a1[v] = __fmaf_rn(w1[j], th[j][v], a1[v]);\n",
           "          if (j == i) a0[v] = th[j][v] + w0[j];\n"
           "          if (j == i1) a1[v] = th[j][v] + w1[j];\n")],
    "o": [(DECLS, ""), (C0, C0 + DECLS + FIRST_LOADS),
          ("      load_cols<T, KMAX, V, V>(L, k, c, th, gr);\n",
           "      if (p > 0) load_cols<T, KMAX, V, V>(L, k, c, th, gr);\n"),
          ("    load_cols<T, KMAX, V, 1>(L, k, c, th, gr);\n",
           "    if (p > 0) load_cols<T, KMAX, V, 1>(L, k, c, th, gr);\n")],
    "k": [("const int kmax = k <= 8 ? 8 : (k <= 16 ? 16 : (k <= 32 ? 32 : 64));",
           "const int kmax = k == 10 ? 10 : (k <= 8 ? 8 : (k <= 16 ? 16 : (k <= 32 ? 32 : 64)));"),
          ("    case 8: return launch_stacked<T, 8>(t, ctas, stream);\n",
           "    case 8: return launch_stacked<T, 8>(t, ctas, stream);\n"
           "    case 10: return launch_stacked<T, 10>(t, ctas, stream);\n")],
}
WRONG = set("ec")  # variants whose outputs are not meant to be right
MLP_D = [100352, 128, 8192, 64, 640, 10]


def variant_source(name: str) -> str:
    text = SOURCE.read_text()
    for letter in ("" if name == "base" else name):
        for old, new in EDITS[letter]:
            assert text.count(old) == 1, (letter, old)
            text = text.replace(old, new)
    return text


def build(names, parent):
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = OUT / f"b1_{name}.cu"
        src.write_text(variant_source(name) if name != "parent"
                       else (Path(parent) / PARENT_SOURCE).read_text())
        procs[name] = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                                        str(src.with_suffix(".so")), str(src)],
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} does not build:\n{err}")
        regs = re.findall(r"Function properties for (\S*stacked\S*)[\s\S]*?Used (\d+) registers",
                          out + err)
        libs[name] = (OUT / f"b1_{name}.so", [(re.sub(r"^_Z\w*?kernel", "", f)[:24], r)
                                              for f, r in regs])
    return libs


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("b1_variants: no CUDA device is available", file=sys.stderr)
        return 2
    parent = None
    if "--parent" in argv:
        i = argv.index("--parent")
        parent = argv[i + 1]
        argv = argv[:i] + argv[i + 2:] + ["parent"]
    libs = build(argv, parent)
    print(cs.nvidia_smi(), flush=True)
    k = cs.K
    gen = torch.Generator(device="cuda").manual_seed(0)
    w = torch.from_numpy(metropolis_weights(build_graph("erdos_renyi", k, p=0.3, seed=0))
                         .astype(np.float32)).cuda()
    s = torch.rand((k,), generator=gen, device="cuda") + 0.5
    thetas = [torch.randn((k, d), generator=gen, device="cuda") for d in MLP_D]
    grads = [torch.randn((k, d), generator=gen, device="cuda") for d in MLP_D]
    want = gk.gossip_update_stacked_grouped(thetas, grads, w, s, eta=0.01)
    cases = {"d 10": [5], "d 100352": [0], "mlp 6 leaves": list(range(6))}
    built_entry = _build.entry
    try:
        for name in argv:
            lib = ctypes.CDLL(str(libs[name][0]))
            if name == "parent":
                fn = lib.gossip_update_stacked_f32
                fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong,
                                                       ctypes.c_float, ctypes.c_void_p]
                fn.restype = ctypes.c_int

                def call(leaves, fn=fn):
                    outs = []
                    for i in leaves:
                        out = torch.empty_like(thetas[i])
                        err = fn(thetas[i].data_ptr(), grads[i].data_ptr(), w.data_ptr(),
                                 s.data_ptr(), out.data_ptr(), k, MLP_D[i], 0.01,
                                 _build.stream(out.device))
                        if err:
                            raise RuntimeError(f"parent launch failed: cudaError_t {err}")
                        outs.append(out)
                    return outs
            else:
                def entry(source, symbol, argtypes, lib=lib):
                    if symbol != "gossip_update_stacked_grouped_f32":
                        return built_entry(source, symbol, argtypes)
                    fn = getattr(lib, symbol)
                    fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
                    return fn

                def call(leaves, entry=entry):
                    _build.entry = entry
                    try:
                        return gk.gossip_update_stacked_grouped(
                            [thetas[i] for i in leaves], [grads[i] for i in leaves], w, s,
                            eta=0.01)
                    finally:
                        _build.entry = built_entry

            row = []
            for tag, leaves in cases.items():
                got = call(leaves)
                torch.cuda.synchronize()
                # the parent sums over j in the same order: its bits are the grouped kernel's
                ok = all(torch.equal(g, want[i]) for g, i in zip(got, leaves))
                dev = cs.window_device_ms(lambda: call(leaves), 50)
                note = "" if ok else (" (wrong, as meant)" if set(name) & WRONG else " (WRONG)")
                row.append(f"{tag} {1e3 * dev:.2f}{note}")
            print(f"{name} (registers {libs[name][1]}), device us: " + " | ".join(row),
                  flush=True)
    finally:
        _build.entry = built_entry
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
