"""Time variants of B.7's backward kernel on the card.

    python tests/wkv6_bwd_variants.py [--root DIR] base f r b s F frb ...

Each argument is one variant of ``rwkv6_scan/csrc/wkv6_bwd.cu``, named by
the letters of the edits it makes (``base``: none).  ``--root DIR`` takes
the source and the port's wrapper from another checkout (e.g. the parent,
unpacked under ``build/``); the edits are text replacements, and a letter
names one edit of each design it applies to (a letter that matches
neither raises).

Cuts (outputs wrong, only timed), for how the time splits:
``F`` no first sweep at all (neither its staging nor its checkpoints),
``f`` the first sweep's arithmetic only, ``r`` no recompute of the chunk's
states (nor dr), ``b`` no reverse walk (the steps that carry G), ``s`` no
staging of the chunks (the compute reads whatever the buffers hold; the
design that stages by TMA issues and waits on no copy); in the redesign
also ``p`` no checkpoint stores, ``j`` no joins (the row sums across the
cluster and dv's sums) and ``K`` the first sweep's copies carrying k alone
(its bytes' share).  Letters combine: ``frb`` is the staging, the joins and
the launch alone.  ``T`` probes the redesign: every CTA's start and end on
the global timer and its SM cycles per phase, summed over the stages,
written over dk's first step and printed as percentiles and medians.

Shapes of the design with register tiles (``csrc/wkv6_bwd.cu`` as
redesigned; right outputs): at hd 64 ``4`` a cluster of 4 CTAs per (batch,
head) instead of 2, ``8`` of 8; at hd 16 ``h`` 1 column per thread instead
of 2 (64 threads), ``k`` clusters of 2 with 1 column per thread.

Every variant is built with the port's nvcc flags (all started together),
checked against the plain version (``wkv6_bwd_ref``, at ``WKV_BWD_REL``)
where its outputs are meant to be right, and timed through the wrapper
(device time under the profiler, ``chip_smoke.device_ms``) at rwkv6-7b's
training shape (B 2, H 64, T 64, hd 64), at hd 16 (B 2, H 256, T 64), at
T = 19 from a given state and at hd 16 (B 2, H 8, T 37) from a given state:
chip_smoke.py's WKV6_TRAIN_CASES shapes, with the sum of du over the
batches (its own kernel) beside.  Prints the registers each kernel uses.
Needs a CUDA device and nvcc; writes the variants under build/.
"""

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
ROOT = REPO
if "--root" in sys.argv:
    _i = sys.argv.index("--root")
    ROOT = Path(sys.argv[_i + 1]).resolve()
    del sys.argv[_i:_i + 2]
sys.path[:0] = [str(ROOT / "src"), str(REPO)]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.rwkv6_scan import kernel as wk  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import wkv6_bwd_ref  # noqa: E402

CSRC = ROOT / "src/repro_torch/kernels/rwkv6_scan/csrc"
SOURCE = CSRC / "wkv6_bwd.cu"
OUT = REPO / "build/wkv6_bwd_variants"
NAMES = ("wkv6_bwd_kernel", "wkv6_du_kernel")

# letter -> alternatives, one per design: the first whose every `old` is in
# the source is applied
EDITS = {
    # -- the first design (one CTA per (head, batch), a first sweep writing dr)
    "F": [[("for (int ch = 0; ch < n_chunks; ++ch) {", "for (int ch = 0; ch < 0; ++ch) {")],
          [("for (int s = 0; s < n_ck; ++s) {\n    const int q = s / SCH",
            "for (int s = 0; s < 0; ++s) {\n    const int q = s / SCH"),
           ("const int n_sc = (n_ck + SCH - 1) / SCH;", "const int n_sc = 0;")]],
    "f": [[("    for (int c = 0; c < n; ++c) {\n      const float ri = rr[c * HD + i], "
            "ki = kk[c * HD + i], wi = ww[c * HD + i];\n      const float uk",
            "    for (int c = 0; c < 0; ++c) {\n      const float ri = rr[c * HD + i], "
            "ki = kk[c * HD + i], wi = ww[c * HD + i];\n      const float uk")],
          [("#pragma unroll 2\n    for (int c = 0; c < C; ++c) {",
            "#pragma unroll 2\n    for (int c = 0; c < 0; ++c) {")]],
    "r": [[("    for (int c = 0; c < n; ++c) {\n      const float ki = kk[c * HD + i], "
            "wi = ww[c * HD + i];",
            "    for (int c = 0; c < 0; ++c) {\n      const float ki = kk[c * HD + i], "
            "wi = ww[c * HD + i];")],
          [("    if (FULL || c < n) {\n      float v[J], dy[J], p[4];",
            "    if (false) {\n      float v[J], dy[J], p[4];")]],
    "b": [[("for (int c = n - 1; c >= 0; --c) {", "for (int c = n - 1; c >= n; --c) {")],
          [("    if (FULL || c < n) {\n      float v[J], dy[J], dk[4]",
            "    if (false) {\n      float v[J], dy[J], dk[4]")]],
    "s": [[("  for (int idx = threadIdx.x; idx < 5 * n * HD; idx += K::NT) {",
            "  for (int idx = threadIdx.x; idx < 0; idx += K::NT) {")],
          [("mbar_wait(", "(void)("), ("tma_tiles(smem", "if (false) tma_tiles(smem")]],
    # the first sweep's copies carry k alone (w and v stale): its bytes' share
    "K": [[("&a.map[5], 3, SCH * TILE,", "&a.map[5], 1, SCH * TILE,")]],
    "p": [[("for (int e = 0; e < 4; ++e) store_j<J>(ck + s * CK_CHUNK",
            "for (int e = 0; e < 0; ++e) store_j<J>(ck + s * CK_CHUNK")]],
    "j": [[("        const int c = part + NPART * k;\n        if (c < n) {",
            "        const int c = part + NPART * k;\n        if (false) {"),
           ("      if (c < n) {\n        a.grad[3]", "      if (false) {\n        a.grad[3]")]],
    # a probe of the redesign (outputs wrong): SM clock cycles per phase
    # summed over the stages, and every CTA's start and end on the global
    # timer, written over dk's first step (see probe_report)
    "T": [[("  const int tid = threadIdx.x;\n  const int cgi",
            "  const int tid = threadIdx.x;\n  long long g0, qt = clock64();\n"
            "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g0));\n"
            "  float probe[NPROBE] = {};\n"
            "#define PROBE(i) { const long long q_ = clock64(); probe[i] += q_ - qt; qt = q_; }\n"
            "  const int cgi"),
           ("  // -- the first sweep: S alone, saved at each chunk's start\n",
            "  PROBE(0)\n  // -- the first sweep: S alone, saved at each chunk's start\n"),
           ("                  static_cast<long long>(q + 1) * SCH * C, h, b, &bar[3 + (slot ^ 1)]);\n"
            "    }\n",
            "                  static_cast<long long>(q + 1) * SCH * C, h, b, &bar[3 + (slot ^ 1)]);\n"
            "    }\n    PROBE(1)\n"),
           ("  if (n_ck > 0) {\n    __syncthreads();  // every thread is done with the slots\n",
            "  PROBE(2)\n  if (n_ck > 0) {\n    __syncthreads();  // every thread is done with the slots\n"),
           ("  // -- the chunks from the last: recompute the states, walk back with G\n",
            "  PROBE(3)\n  // -- the chunks from the last: recompute the states, walk back with G\n"),
           ("      load_tiles<HD>(smem + nb * K::BUF, a, base, dybase, t0, n, 0, 5, TILE);\n"
            "      __syncthreads();\n    }\n",
            "      load_tiles<HD>(smem + nb * K::BUF, a, base, dybase, t0, n, 0, 5, TILE);\n"
            "      __syncthreads();\n    }\n    PROBE(4)\n"),
           ("    // the chunk's bonus sum_i r_i u_i k_i",
            "    PROBE(5)\n    // the chunk's bonus sum_i r_i u_i k_i"),
           ("    // this CTA's partials and scalars are written",
            "    PROBE(6)\n    // this CTA's partials and scalars are written"),
           ("    // columns [cb CW, (cb + 1) CW): dv's partials over the row groups in order\n",
            "    PROBE(7)\n    // columns [cb CW, (cb + 1) CW): dv's partials over the row groups in order\n"),
           ("    if constexpr (NC > 1) cluster_wait();\n    // rows [cb RC",
            "    PROBE(8)\n    if constexpr (NC > 1) cluster_wait();\n    PROBE(9)\n    // rows [cb RC"),
           ("          du = fmaf(ri * ki, vd, du);\n        }\n      }\n    }\n  }\n",
            "          du = fmaf(ri * ki, vd, du);\n        }\n      }\n    }\n    PROBE(10)\n  }\n"),
           ("  if (a.ds0) {\n#pragma unroll\n    for (int e = 0; e < 4; ++e)\n#pragma unroll\n"
            "      for (int jj = 0; jj < J; ++jj)\n        a.ds0",
            "  PROBE(11)\n  if (tid == 0) {\n    long long g1;\n"
            "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g1));\n"
            "    float* o = a.grad[1] + obase + 16 * cb;\n"
            "    o[0] = __int_as_float(static_cast<int>(g0));\n"
            "    o[1] = __int_as_float(static_cast<int>(g1));\n"
            "    for (int x = 0; x < NPROBE; ++x) o[2 + x] = probe[x];\n  }\n"
            "  if (a.ds0) {\n#pragma unroll\n    for (int e = 0; e < 4; ++e)\n#pragma unroll\n"
            "      for (int jj = 0; jj < J; ++jj)\n        a.ds0"),
           ("namespace cg = cooperative_groups;\n", "namespace cg = cooperative_groups;\n"
            "constexpr int NPROBE = 12;\n")]],
}
PROBE = ("prologue", "sweep waits", "sweep work", "post-sweep barrier", "waits", "steps",
         "scalars", "barrier and issue", "dv join", "cluster wait", "row join", "epilogue")
# the redesign's shapes: letter -> (head dim, field of Shape<hd>, value); they combine
SHAPE_LETTERS = {"4": (64, "NC", 4), "8": (64, "NC", 8), "h": (16, "J", 1), "k": (16, "NC", 2)}
WRONG = set("FfrbspjTK")  # letters whose variants' outputs are not meant to be right
# chip_smoke.py's WKV6_TRAIN_CASES shapes
SHAPES = [("train B 2 H 64 T 64 hd 64", 2, 64, 64, 64, False),
          ("hd 16 B 2 H 256 T 64", 2, 256, 64, 16, False),
          ("T 19 given state", 2, 64, 19, 64, True),
          ("hd 16 B 2 H 8 T 37 given state", 2, 8, 37, 16, True)]


def variant_source(name: str) -> str:
    text = SOURCE.read_text()
    for flag in "" if name == "base" else name:
        if flag in SHAPE_LETTERS:
            hd, field, value = SHAPE_LETTERS[flag]
            head = f"struct Shape<{hd}> {{\n  static constexpr int "
            at = text.index(head) + len(head)
            end = text.index(";", at)
            fields = dict(f.split(" = ") for f in text[at:end].split(", "))
            fields[field] = str(value)
            if field == "NC" and hd == 16:
                fields["J"] = "1"  # 32 threads: 8 columns of one each
            text = text[:at] + ", ".join(f"{k} = {v}" for k, v in fields.items()) + text[end:]
            continue
        for alternative in EDITS[flag]:
            if all(old in text for old, _ in alternative):
                for old, new in alternative:
                    text = text.replace(old, new)
                break
        else:
            raise ValueError(f"variant letter {flag!r} matches no design of {SOURCE}")
    return text


def build(names) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {name: variant_source(name) for name in names}
    procs = {}
    for name, text in sources.items():
        src = OUT / f"wkv6_bwd_{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(CSRC),
                                        "-o", str(src.with_suffix(".so")), str(src)],
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    try:
        for name, proc in procs.items():
            out, err = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"variant {name} does not build:\n{err}")
            libs[name] = (OUT / f"wkv6_bwd_{name}.so",
                          re.findall(r"Used (\d+) registers", out + err),
                          re.findall(r"(\d+) bytes spill stores", out + err))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return libs


def probe_report(dk, r, nc: int) -> str:
    """The probe's numbers out of dk's first step (per CTA: start and end on
    the global timer, low 32 bits; SM cycles per phase): the kernel's span,
    each CTA's duration and start offset (percentiles), and the median
    cycles of each phase."""
    b, h, _, hd = r.shape
    raw = dk[:, :, 0, :].contiguous().reshape(b * h, hd)
    rows = torch.cat([raw[:, 16 * c:16 * c + 2 + len(PROBE)] for c in range(nc)]).cpu()
    bits = rows[:, :2].contiguous().view(torch.int32).to(torch.int64)
    start, end = bits[:, 0], bits[:, 1]
    base = int(start.min())
    start, end = (start - base) % (1 << 32), (end - base) % (1 << 32)
    q = torch.tensor([0.0, 0.5, 0.9, 1.0], dtype=torch.float64)
    pct = lambda x: "/".join(f"{v / 1e3:.1f}" for v in torch.quantile(x.double(), q).tolist())
    phases = ", ".join(f"{n} {float(rows[:, 2 + i].median()):.0f}" for i, n in enumerate(PROBE))
    return (f"{rows.shape[0]} CTAs, span {float(end.max()) / 1e3:.1f} us; duration us "
            f"min/med/p90/max {pct(end - start)}; start us {pct(start)}; cycles: {phases}")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("wkv6_bwd_variants: no CUDA device is available", file=sys.stderr)
        return 2
    libs = build(argv)
    print(cs.nvidia_smi(), flush=True)
    print(f"source {SOURCE}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {}
    for tag, b, h, t, hd, given in SHAPES:
        r, k, v, dy = (torch.randn((b, t, h, hd), generator=gen, device="cuda")
                       .permute(0, 2, 1, 3) for _ in range(4))
        w = torch.rand((b, t, h, hd), generator=gen, device="cuda").permute(0, 2, 1, 3)
        u = 0.5 * torch.randn((h, hd), generator=gen, device="cuda")
        s0, ds = ((torch.randn((b, h, hd, hd), generator=gen, device="cuda") for _ in range(2))
                  if given else (None, None))
        args = (r, k, v, w, u, dy, s0, ds)
        inputs[tag] = (args, wkv6_bwd_ref(*args))
    built_entry = _build.entry
    source_key = wk.BWD_SOURCE
    for name in argv:
        lib = ctypes.CDLL(str(libs[name][0]))

        def entry(source, symbol, argtypes, lib=lib):
            if source != source_key:
                return built_entry(source, symbol, argtypes)
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
            return fn

        _build.entry = entry
        row = []
        for tag, (args, plain) in inputs.items():
            got = wk.wkv6_bwd(*args)
            torch.cuda.synchronize()
            ok = all(cs._rel_err(g, p) <= cs.WKV_BWD_REL
                     for g, p in zip(got, plain) if p is not None)
            dev = cs.device_ms(lambda args=args: wk.wkv6_bwd(*args), 20, NAMES)
            note = "" if ok else (" (wrong, as meant)" if set(name) & WRONG else " (WRONG)")
            du = cs.device_ms(lambda args=args: wk.wkv6_bwd(*args), 20, NAMES[1:])
            note += f" (du's sum over the batches {1e3 * du:.2f})"
            row.append(f"{tag} {1e3 * dev:.2f}{note}")
        if "T" in name:
            for tag, (args, _) in inputs.items():
                hd = args[0].shape[3]
                nc = int(re.search(rf"struct Shape<{hd}> {{\n  static constexpr int NC = (\d+)",
                                   variant_source(name)).group(1))
                dk = wk.wkv6_bwd(*args)[1]
                print(f"  probe {name} {tag}: {probe_report(dk, args[0], nc)}", flush=True)
        regs, spills = libs[name][1], libs[name][2]
        print(f"{name} (registers {'/'.join(regs)}, spill stores {'/'.join(spills)}), "
              "device us: " + " | ".join(row), flush=True)
    _build.entry = built_entry
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
