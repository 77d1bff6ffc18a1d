"""Plain PyTorch versions of the quant_gossip kernels.

Bit-exact against the CUDA kernels given the same inputs: every step is one
correctly rounded float32 operation.

* quantize: ``scale = absmax / qmax`` (1 where the block is all zero) and
  ``q = clip(floor(x / scale + u), ±qmax)``, bit-exact against the
  reference's ``quantize_blockwise_ref`` too.  ``qmax`` is a float or a
  0-d float32 tensor (a schedule's rate), divided as a tensor on ``x``'s
  device either way: PyTorch's CUDA division by a Python number multiplies
  by its reciprocal, which is not correctly rounded and would move
  ``scale`` by an ulp.
* masked quantize: a masked row gives q = 0 and scale·m = 0, as the
  reference's oracle does.
* the grouped forms (every leaf of one matching in one call, as the card
  runs them) are loops over the one-leaf versions; the grouped accumulate
  writes into each ``acc`` in place, as the kernel does.
* dequantize-accumulate: ``acc + (a·scale)·q`` with ``a = w`` (or
  ``m·w``), the multiplication order of the reference's Pallas kernels
  (``kernel.py:46, 70``).  The reference's jnp oracle computes
  ``acc + w·(q·scale)``, which can differ by an ulp.  A row with a = 0
  returns ``acc`` bitwise, as the CUDA kernel does without reading q.
  ``src`` gathers the row each node receives from (the one-card
  ``ppermute``).
* uniforms: Philox-4x32-10 in int64 torch ops, each 32-bit product taken
  from the multiplier's 16-bit halves (a product of two 32-bit words passes
  2**63, which int64 cannot hold), and the same exact conversion to float32
  as the kernel's (``csrc/philox.cu``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.quant_gossip.kernel import _pick_block, check_uniforms_args

PHILOX_M = (0xD2511F53, 0xCD9E8D57)   # Random123's Philox-4x32 multipliers
PHILOX_W = (0x9E3779B9, 0xBB67AE85)   # its Weyl key increments
_LO32 = 0xFFFFFFFF


def _blocked(x: torch.Tensor, n_blk: int) -> torch.Tensor:
    k, d = x.shape
    return x.reshape(k, n_blk, d // n_blk)


def quantize_blockwise_ref(x, u, *, qmax: float | torch.Tensor = 127.0, block_d: int = 65536):
    """x, u: (K, D) -> (q int8 (K, D), scales f32 (K, D/block))."""
    k, d = x.shape
    n_blk = d // _pick_block(d, block_d)
    xb = _blocked(x.float(), n_blk)
    qmax_t = qmax.to(device=x.device, dtype=torch.float32) if isinstance(qmax, torch.Tensor) \
        else torch.full((), float(qmax), dtype=torch.float32, device=x.device)
    absmax = xb.abs().amax(dim=2, keepdim=True)
    scale = torch.where(absmax > 0, absmax / qmax_t, torch.ones_like(absmax))
    y = torch.floor(xb / scale + _blocked(u.float(), n_blk))
    q = torch.clamp(y, -qmax_t, qmax_t).to(torch.int8)
    return q.reshape(k, d), scale.reshape(k, n_blk)


def dequantize_blockwise_ref(q, scales):
    """(K, D) int8 + (K, n_blk) scales -> (K, D) float32."""
    k, d = q.shape
    n_blk = scales.shape[1]
    return (_blocked(q.float(), n_blk) * scales[:, :, None]).reshape(k, d)


def masked_quantize_blockwise_ref(x, u, mask, *, qmax: float | torch.Tensor = 127.0,
                                  block_d: int = 65536):
    """Masked-sender version: rows with mask 0 emit zero payload and zero
    scales."""
    q, scales = quantize_blockwise_ref(x, u, qmax=qmax, block_d=block_d)
    m = mask.reshape(-1, 1).float()
    q = torch.where(m > 0, q, torch.zeros_like(q))
    return q, scales * m


def _gather(q, scales, src):
    if src is None:
        return q, scales
    return q[src], scales[src]


def dequant_accumulate_ref(acc, q, scales, w, *, src=None):
    """acc + (w·scale)·q on the rows ``src`` selects; rows with w = 0 give
    acc bitwise."""
    q, scales = _gather(q, scales, src)
    a = w.reshape(-1, 1).float()
    k, d = acc.shape
    n_blk = scales.shape[1]
    out = _blocked(acc, n_blk) + (a * scales)[:, :, None] * _blocked(q.float(), n_blk)
    return torch.where(a != 0, out.reshape(k, d), acc)


def masked_dequant_accumulate_ref(acc, q, scales, w, mask, *, src=None):
    """acc + ((m·w)·scale)·q; masked rows give acc bitwise."""
    a = mask.reshape(-1).float() * w.reshape(-1).float()
    return dequant_accumulate_ref(acc, q, scales, a, src=src)


def quantize_blockwise_grouped_ref(xs, us,
                                   *, qmax: float | torch.Tensor = 127.0, block_d: int = 65536):
    """[(q_l, scales_l)] of :func:`quantize_blockwise_ref` per leaf."""
    return [quantize_blockwise_ref(x, u, qmax=qmax, block_d=block_d) for x, u in zip(xs, us)]


def masked_quantize_blockwise_grouped_ref(xs, us, mask, *, qmax: float | torch.Tensor = 127.0,
                                          block_d: int = 65536):
    """[(q_l, scales_l)] of :func:`masked_quantize_blockwise_ref` per leaf."""
    return [masked_quantize_blockwise_ref(x, u, mask, qmax=qmax, block_d=block_d)
            for x, u in zip(xs, us)]


def masked_dequant_accumulate_grouped_ref_(accs, payloads, w, mask, *, src=None):
    """Each ``acc_l`` overwritten in place with
    :func:`masked_dequant_accumulate_ref` of it; returns ``accs``."""
    for acc, (q, scales) in zip(accs, payloads):
        acc.copy_(masked_dequant_accumulate_ref(acc, q, scales, w, mask, src=src))
    return accs


def dequant_accumulate_grouped_ref_(accs, payloads, w, *, src=None):
    """Each ``acc_l`` overwritten in place with
    :func:`dequant_accumulate_ref` of it; returns ``accs``."""
    for acc, (q, scales) in zip(accs, payloads):
        acc.copy_(dequant_accumulate_ref(acc, q, scales, w, src=src))
    return accs


# counters per pass on the CPU: every op of a pass (the stacked (2, n)
# words, the (n, 4) draws) then stays under PyTorch's grain of 32,768
# elements and runs on the calling thread, so a pass of ~130 small ops never
# waits on the intra-op pool (where processes share the cores, each parallel
# op waits for every pool thread to be scheduled)
CPU_PASS = 8191


def philox4x32_10_ref(c: list, k0, k1) -> list:
    """Philox-4x32-10 of the counters ``c`` (four int64 tensors of 32-bit
    words) under the key (k0, k1) (host ints of 32-bit words): the four
    output words, int64 tensors in [0, 2**32).  Each 32-bit product m·x is
    taken from the multiplier's 16-bit halves, m = mh·2**16 + ml, so that
    no int64 product passes 2**48; the two products of a round run stacked
    as one (2, n) tensor, in place."""
    x = torch.stack([c[0], c[2]])   # the words multiplied: (c0, c2)
    y = torch.stack([c[1], c[3]])   # the words xored in:   (c1, c3)
    # per-row constants by fills (no tensor made from host data)
    ml, mh, key = (x.new_empty((2, 1)) for _ in range(3))
    for row, m in enumerate(PHILOX_M):
        ml[row].fill_(m & 0xFFFF)
        mh[row].fill_(m >> 16)
    p_lo, t, lo = (torch.empty_like(x) for _ in range(3))
    for _ in range(10):
        torch.mul(x, ml, out=p_lo)                 # x·ml < 2**48
        torch.mul(x, mh, out=t)
        t.add_(p_lo >> 16)                         # m·x >> 16, below 2**49
        torch.bitwise_and(t, 0xFFFF, out=lo)
        lo.bitwise_left_shift_(16).bitwise_or_(p_lo.bitwise_and_(0xFFFF))  # low words
        t.bitwise_right_shift_(16)                 # high words (hi0, hi1)
        # (c0, c1, c2, c3) <- (hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0)
        key[0].fill_(k0)
        key[1].fill_(k1)
        torch.bitwise_xor(t.flip(0), y, out=x)
        x.bitwise_xor_(key)
        y.copy_(lo.flip(0))
        k0, k1 = (k0 + PHILOX_W[0]) & _LO32, (k1 + PHILOX_W[1]) & _LO32
    return [x[0], y[0], x[1], y[1]]


def uniforms_grouped_ref(xs, key: int, round: torch.Tensor, *, matching: int = 0,
                         leaves=None, divisors=None) -> list:
    """The kernel's uniforms of every leaf of a group, one float32 tensor
    shaped like each of ``xs``: element e of leaf l is word (e mod 4) of
    Philox((e >> 2, l, matching, floor(round / d_l) mod 2**32), key) >> 8,
    times 2**-24, with d_l the leaf's round divisor (1 by default).
    ``round`` is read as a tensor (never on the host).  Each leaf's counters
    run in one pass on the card and in passes of :data:`CPU_PASS` on the
    CPU."""
    leaves, divisors = check_uniforms_args("uniforms_grouped_ref", xs, key, round, matching,
                                           leaves, divisors)
    key &= 2 ** 64 - 1
    outs = []
    for x, leaf, d in zip(xs, leaves, divisors):
        r = ((round if d == 1 else torch.div(round, d, rounding_mode="floor")) & _LO32
             ).reshape(1)
        n = x.numel()
        counters = -(-n // 4)
        step = CPU_PASS if x.device.type == "cpu" else max(counters, 1)
        u = torch.empty(4 * counters, dtype=torch.float32, device=x.device)
        for lo in range(0, counters, step):
            hi = min(lo + step, counters)
            g = torch.arange(lo, hi, dtype=torch.int64, device=x.device)
            words = philox4x32_10_ref([g, torch.full_like(g, leaf), torch.full_like(g, matching),
                                       r.expand_as(g)], key & _LO32, key >> 32)
            u[4 * lo:4 * hi].copy_(((torch.stack(words, 1) >> 8).to(torch.float32)
                                    * 2.0 ** -24).reshape(-1))
        outs.append(u[:n].reshape(x.shape))
    return outs
