"""The plain version of B.7's backward against autograd and the reference.

``repro_torch/kernels/rwkv6_scan/ref.py::wkv6_bwd_ref`` is the backward of
the WKV6 recurrence as an explicit reverse loop: what the backward kernel
(``csrc/wkv6_bwd.cu``) is held against on the card (tests/test_torch_kernel.py,
``chip_smoke.py``'s ``train-rwkv`` phase).  Here, on the CPU, with inputs
made by numpy from a seed, every gradient is held within ``REL`` = 1e-4 of
its own largest |value| against:

* ``jax.vjp`` of the reference's oracle ``repro.kernels.rwkv6_scan.ref.
  wkv6_ref`` (dr, dk, dv, dw, du; that oracle starts from zero and drops
  the final state);
* ``torch.autograd`` of the port's ``wkv6_ref`` with a given s0 and a
  cotangent on the final state (ds0 besides);
* ``jax.vjp`` of the reference's ``repro.models.ssm.rwkv_forward`` on a
  smoke block with a given state, cotangents on y and on every leaf of the
  new state: the port's ``rwkv_forward`` differentiated with its WKV6 call
  routed through a Function whose backward is ``wkv6_bwd_ref``.

Cases: hd 16 and 64; decay drawn in (0, 1), near 1 (the init's
exp(-exp(-6))) and w = 1e-6 (the state forgotten at every step); T = 1 and
T that is not a multiple of the kernel's checkpoint stride (16 at hd 16, 8
at hd 64).  Measured on the CPU, the largest relative difference is ~1e-6.

The kernel's summation order (``csrc/wkv6_bwd.cu``: the column split over a
cluster of NC CTAs, a thread's 4 x J tile with its row slots permuted by
its column-group bits, the lanes' reduce-scatter, the cluster's join in
rank order, dv's partials over the row groups in order, the bonus and
v . dy per step over P lanes, du over the join threads and the batches) is
modelled in float32 on the CPU by :func:`tiled_wkv6_bwd` and held against
``jax.vjp`` of the reference's oracle and autograd of the port's plain
version at ``REL``, at hd 16 and 64, with T below, at and off a chunk and
past the first sweep's first copy (4 chunks), and from a given state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.kernels.rwkv6_scan.ref import wkv6_ref as ref_wkv6
from repro.models import TransformerLM as RefLM
from repro.models.ssm import rwkv_forward as ref_rwkv_forward
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.kernels.rwkv6_scan import kernel as wk
from repro_torch.kernels.rwkv6_scan import ops
from repro_torch.kernels.rwkv6_scan.ref import wkv6_bwd_ref, wkv6_ref
from repro_torch.models.ssm import rwkv_forward

REL = 1e-4
# the backward kernel's shapes per head dim (csrc/wkv6_bwd.cu, Shape<hd>; a
# card test holds them against the compiled kernel): CTAs per cluster,
# columns per thread, steps per chunk (the checkpoint stride)
SHAPE = wk.BWD_SHAPE
CHUNK = {hd: shape["c"] for hd, shape in SHAPE.items()}
NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _inputs(seed, b, h, t, hd, decay):
    rng = np.random.default_rng(seed)
    r, k, v, dy = (rng.standard_normal((b, h, t, hd)).astype(np.float32) for _ in range(4))
    if decay == "random":
        w = rng.uniform(0.0, 1.0, (b, h, t, hd)).astype(np.float32)
    elif decay == "near 1":  # the model's init: exp(-exp(-6)) ~ 0.9975
        w = np.full((b, h, t, hd), np.exp(-np.exp(-6.0)), np.float32)
    else:  # the state is forgotten at every step
        w = np.full((b, h, t, hd), 1e-6, np.float32)
    u = (0.5 * rng.standard_normal((h, hd))).astype(np.float32)
    s0, ds = (rng.standard_normal((b, h, hd, hd)).astype(np.float32) for _ in range(2))
    return r, k, v, w, u, dy, s0, ds


CASES = [(hd, t, decay) for hd in (16, 64) for t in (1, CHUNK[hd] * 2 + 3)
         for decay in ("random", "near 1", "1e-6")]


@pytest.mark.parametrize("hd,t,decay", CASES)
def test_bwd_ref_matches_jax_vjp_of_reference(hd, t, decay):
    r, k, v, w, u, dy, _, _ = _inputs(hd + t, 2, 2, t, hd, decay)
    _, vjp = jax.vjp(ref_wkv6, *(jnp.asarray(x) for x in (r, k, v, w, u)))
    want = vjp(jnp.asarray(dy))
    got = wkv6_bwd_ref(*(torch.from_numpy(x) for x in (r, k, v, w, u, dy)))
    assert got[5] is None
    for name, g, wnt in zip(NAMES, got[:5], want):
        assert g.shape == wnt.shape, name
        assert _rel(g.numpy(), wnt) <= REL, (name, _rel(g.numpy(), wnt))


@pytest.mark.parametrize("hd,t,decay", CASES)
def test_bwd_ref_matches_autograd_with_state(hd, t, decay):
    """With a given s0 and a cotangent on the final state."""
    xs = [torch.from_numpy(x) for x in _inputs(hd * t, 2, 3, t, hd, decay)]
    r, k, v, w, u, dy, s0, ds = xs
    leaves = [x.clone().requires_grad_() for x in (r, k, v, w, u, s0)]
    y, s = wkv6_ref(*leaves)
    want = torch.autograd.grad((y * dy).sum() + (s * ds).sum(), leaves)
    got = wkv6_bwd_ref(r, k, v, w, u, dy, s0, ds)
    for name, g, wnt in zip(NAMES, got, want):
        assert _rel(g, wnt) <= REL, (name, _rel(g, wnt))
    # no cotangent on the final state: the same as a zero one
    zero = wkv6_bwd_ref(r, k, v, w, u, dy, s0, torch.zeros_like(ds))
    for g, z in zip(wkv6_bwd_ref(r, k, v, w, u, dy, s0), zero):
        assert torch.equal(g, z)


class _PlainWKV6(torch.autograd.Function):
    """``ops.WKV6`` with the plain versions in place of the kernels."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        ctx.save_for_backward(r, k, v, w, u, s0)
        ctx.set_materialize_grads(False)
        return wkv6_ref(r, k, v, w, u, s0)

    @staticmethod
    def backward(ctx, dy, ds):
        r, k, v, w, u, s0 = ctx.saved_tensors
        return wkv6_bwd_ref(r, k, v, w, u, torch.zeros_like(r) if dy is None else dy, s0, ds)


@pytest.mark.parametrize("seq,decay_base", [(1, -6.0), (19, -6.0), (19, 2.6), (37, None)])
def test_rwkv_forward_grads_match_reference(monkeypatch, seq, decay_base):
    """The smoke block (hd 16) from a given state: decay near 1 (the init's
    decay_base -6), near 1e-6 (decay_base 2.6: exp(-exp(2.6)) ~ 1.4e-6)
    and drawn per channel in (-3, 1).  Every parameter, x and every leaf
    of the state."""
    calls = []
    monkeypatch.setattr(ops, "wkv6", lambda *xs: calls.append(1) or _PlainWKV6.apply(*xs))
    cfg_ref = ref_get_arch("rwkv6_7b", smoke=True)
    cfg = get_arch("rwkv6_7b", smoke=True)
    params = jax.tree.map(np.asarray, RefLM(cfg_ref).init(jax.random.PRNGKey(0)))
    block = jax.tree.map(lambda a: np.array(a[0]), params["groups"]["l0"]["mix"])
    rng = np.random.default_rng(seq)
    h, hd, d = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim, cfg.d_model
    block["time"]["bonus"] = (0.3 * rng.standard_normal((h, hd))).astype(np.float32)
    block["time"]["decay_base"] = (np.full(d, decay_base, np.float32) if decay_base is not None
                                   else rng.uniform(-3.0, 1.0, d).astype(np.float32))
    b = 2
    x = rng.standard_normal((b, seq, d)).astype(np.float32)
    state = {"x_time": rng.standard_normal((b, d)).astype(np.float32),
             "x_chan": rng.standard_normal((b, d)).astype(np.float32),
             "wkv": rng.standard_normal((b, h, hd, hd)).astype(np.float32)}
    cot_y = rng.standard_normal((b, seq, d)).astype(np.float32)
    cot_s = {name: rng.standard_normal(a.shape).astype(np.float32) for name, a in state.items()}

    def ref_fn(p, x, st):
        return ref_rwkv_forward(p, x, cfg_ref, st)

    _, vjp = jax.vjp(ref_fn, jax.tree.map(jnp.asarray, block), jnp.asarray(x),
                     jax.tree.map(jnp.asarray, state))
    want_p, want_x, want_s = vjp((jnp.asarray(cot_y), jax.tree.map(jnp.asarray, cot_s)))
    want_p = convert._flatten(jax.tree.map(np.asarray, want_p))

    p = {n: t.requires_grad_() for n, t in convert.params_from_numpy(block, device="cpu").items()}
    xt = torch.from_numpy(x).requires_grad_()
    st = {n: torch.from_numpy(a).requires_grad_() for n, a in state.items()}
    y, new = rwkv_forward(p, xt, cfg, st)
    total = (y * torch.from_numpy(cot_y)).sum() + sum(
        (new[n] * torch.from_numpy(cot_s[n])).sum() for n in cot_s)
    assert len(calls) == 1
    names = list(p)
    grads = torch.autograd.grad(total, [p[n] for n in names] + [xt] + [st[n] for n in st])
    for name, g in zip(names, grads):
        assert _rel(g, want_p[name]) <= REL, (name, _rel(g, want_p[name]))
    assert _rel(grads[len(names)], want_x) <= REL
    for name, g in zip(st, grads[len(names) + 1:]):
        assert _rel(g, want_s[name]) <= REL, (name, _rel(g, want_s[name]))


# -- the CUDA kernel's arithmetic order (csrc/wkv6_bwd.cu) ----------------------

def _f32(x):
    """Round float64 values to float32 and keep them in float64, where the
    product of two float32 values is exact."""
    return x.to(torch.float32).to(torch.float64)


def _fma(a, b, c):
    """fma(a, b, c) of float32 values, rounded once (via float64)."""
    return _f32(a * b + c)


def _tree(x):
    """The lanes' shuffle tree over the last axis: the halves added pairwise,
    the highest lane bit first."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = _f32(x[..., :half] + x[..., half:])
    return x[..., 0]


def _in_order(x):
    """A float32 sum over the last axis, from index 0 on."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = _f32(acc + x[..., i])
    return acc


def tiled_wkv6_bwd(r, k, v, w, u, dy, s0=None, ds=None):
    """B.7's backward as csrc/wkv6_bwd.cu orders it, in float32.  numpy in,
    numpy out: (dr, dk, dv, dw (B, H, T, hd), du (H, hd), ds0 or None).

    Columns j = cb CW + J cg + jj (CTA cb of the cluster, column group cg,
    slot jj); rows i = 4 rg + (e ^ m(cg)) (row group rg, slot e).  A row's
    sum: an FMA chain over the thread's J columns from 0, the lanes' tree
    over cg, then the CTAs in rank order, then fma(u_i k_i, v.dy, sum) for
    dr and fma(u_i r_i, v.dy, sum) for dk.  A column's (dv): an FMA chain
    over the thread's slots e = 0..3, the row groups in order, then
    fma(bonus, dy_j, sum).  The bonus sum_i (r_i u_i) k_i and v.dy per step:
    FMA chains over each of P lanes' float4 groups (pp + P q), then the
    lanes' tree.  The state and G: fma(w_i, S, k_i v_j), fma(w_i, G, r_i
    dy_j).  du: per join thread (row, part) over its steps (chunks from the
    last, steps part, part + NPART, ... rising), the parts in order, the
    batches in order."""
    r, k, v, w, dy, u = (torch.from_numpy(x).double() for x in (r, k, v, w, dy, u))
    b, h, t, hd = r.shape
    nc, jn, cn = SHAPE[hd]["nc"], SHAPE[hd]["j"], SHAPE[hd]["c"]
    cw = hd // nc
    ncg, nrg = cw // jn, hd // 4
    nt = ncg * nrg
    p_lanes, npart = nt // cn, nt // (hd // nc)
    lv = min(int(np.log2(ncg)), 2)

    def perm(cg):  # the lane's permutation of its row slots
        return sum(4 >> (lvl + 1) for lvl in range(lv) if cg & (ncg >> (lvl + 1)))

    cols = torch.arange(hd).reshape(nc, ncg, jn)                     # (cb, cg, jj) -> j

    def row_sum(a, x):
        """Per row i: chains over each thread's J columns of fma(a[i, j],
        x[j] (a vector) or x[i, j] (a matrix), .), the tree over cg, the
        CTAs in order.  a (B, H, hd, hd) -> (B, H, hd)."""
        part = torch.zeros((b, h, hd, nc, ncg), dtype=torch.float64)
        for jj in range(jn):
            j = cols[:, :, jj]                                       # (NC, NCG)
            xj = x[:, :, None, j] if x.ndim == 3 else x[:, :, :, j]
            part = _fma(a[:, :, :, j], xj, part)
        return _in_order(_tree(part))

    # per column j, its thread's rows in slot order: (hd, NRG, 4)
    slot_rows = torch.tensor([[[4 * rg + (e ^ perm((j % cw) // jn)) for e in range(4)]
                               for rg in range(nrg)] for j in range(hd)])

    def col_sum(a, x):
        """Per column j: chains over each thread's slots of fma(a[i, j],
        x[i], .), the row groups in order.  -> (B, H, hd)."""
        jj = torch.arange(hd)[:, None]
        acc = torch.zeros((b, h, hd, nrg), dtype=torch.float64)
        for e in range(4):
            i = slot_rows[:, :, e]                                   # (hd, NRG)
            acc = _fma(a[:, :, i, jj], x[:, :, i], acc)
        return _in_order(acc)

    def scalar(x, y, z=None):
        """A per-step sum over P lanes: chains of fma(x, y, .) (of fma(x y,
        z, .), x y rounded, when z is given) over lane pp's elements
        4 (pp + P q) + e, then the lanes' tree."""
        parts = torch.zeros((b, h, p_lanes), dtype=torch.float64)
        for q in range(hd // p_lanes // 4):
            for e in range(4):
                idx = torch.tensor([4 * (pp + p_lanes * q) + e for pp in range(p_lanes)])
                parts = (_fma(x[..., idx], y[..., idx], parts) if z is None else
                         _fma(_f32(x[..., idx] * y[..., idx]), z[..., idx], parts))
        return _tree(parts)

    s = torch.zeros((b, h, hd, hd), dtype=torch.float64) if s0 is None \
        else torch.from_numpy(s0).double()
    states = []
    for i in range(t):
        states.append(s)
        s = _fma(w[:, :, i, :, None], s, _f32(k[:, :, i, :, None] * v[:, :, i, None, :]))
    g = torch.zeros((b, h, hd, hd), dtype=torch.float64) if ds is None \
        else torch.from_numpy(ds).double()
    dr, dk, dv, dw = (torch.zeros((b, h, t, hd), dtype=torch.float64) for _ in range(4))
    vds = {}
    for i in reversed(range(t)):
        rt, kt, vt, wt, dyt = (x[:, :, i] for x in (r, k, v, w, dy))
        bonus, vds[i] = scalar(rt, u[None], kt), scalar(vt, dyt)
        dr[:, :, i] = _fma(_f32(u * kt), vds[i][..., None], row_sum(states[i], dyt))
        dk[:, :, i] = _fma(_f32(u * rt), vds[i][..., None], row_sum(g, vt))
        dw[:, :, i] = row_sum(g, states[i])
        dv[:, :, i] = _fma(bonus[..., None], dyt, col_sum(g, kt))
        g = _fma(wt[..., None], g, _f32(rt[..., :, None] * dyt[..., None, :]))
    du_parts = torch.zeros((b, h, hd, npart), dtype=torch.float64)
    for ch in reversed(range(-(-t // cn))):
        for c in range(cn):
            i = ch * cn + c
            if i < t:
                rk = _f32(r[:, :, i] * k[:, :, i])
                du_parts[..., c % npart] = _fma(rk, vds[i][..., None], du_parts[..., c % npart])
    du = _in_order(_in_order(du_parts).permute(1, 2, 0))             # parts, then batches
    out = [x.float().numpy() for x in (dr, dk, dv, dw, du)]
    return (*out, None if s0 is None else g.float().numpy())


TILED_CASES = [(hd, t) for hd in (16, 64)
               for t in (5, CHUNK[hd], 2 * CHUNK[hd] + 3, 4 * CHUNK[hd] + 1)]


@pytest.mark.parametrize("hd,t", TILED_CASES)
def test_tiled_order_matches_jax_vjp_of_reference(hd, t):
    """The kernel's order from zero state against jax.vjp of the
    reference's oracle: T below, at and off a chunk and past the first
    sweep's first copy of 4 chunks."""
    r, k, v, w, u, dy, _, _ = _inputs(hd * 7 + t, 2, 2, t, hd, "random")
    u = (5.0 * u).astype(np.float32)  # u terms of the state's size
    _, vjp = jax.vjp(ref_wkv6, *(jnp.asarray(x) for x in (r, k, v, w, u)))
    want = vjp(jnp.asarray(dy))
    got = tiled_wkv6_bwd(r, k, v, w, u, dy)
    assert got[5] is None
    for name, g, wnt in zip(NAMES, got[:5], want):
        assert g.shape == wnt.shape, name
        assert _rel(g, wnt) <= REL, (name, _rel(g, wnt))


@pytest.mark.parametrize("hd,t,decay", [(16, 37, "near 1"), (64, 19, "1e-6"), (64, 33, "random")])
def test_tiled_order_matches_autograd_with_state(hd, t, decay):
    """From a given state, with a cotangent on the final state: the kernel's
    order against autograd of the port's plain version (ds0 besides)."""
    xs = _inputs(hd + 3 * t, 2, 2, t, hd, decay)
    r, k, v, w, u, dy, s0, ds = (torch.from_numpy(x) for x in xs)
    leaves = [x.clone().requires_grad_() for x in (r, k, v, w, u, s0)]
    y, s = wkv6_ref(*leaves)
    want = torch.autograd.grad((y * dy).sum() + (s * ds).sum(), leaves)
    got = tiled_wkv6_bwd(*xs)
    for name, g, wnt in zip(NAMES, got, want):
        assert _rel(g, wnt) <= REL, (name, _rel(g, wnt))
