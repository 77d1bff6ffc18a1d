"""The port's LM at ``compute_dtype=bfloat16`` against the reference's.

qwen2 (GQA, QKV bias), h2o-danube (sliding window) and rwkv6 at the smoke
width, cut to 2 layers, with ``compute_dtype`` bfloat16 in both packages:
the reference's
``init(PRNGKey(0))`` carried across with ``convert.params_from_numpy``, the
same numpy-made tokens through ``prefill`` (last logits, every cache leaf)
and three ``decode_step``s from the merged prefill cache.  On the CPU the
port's attention and WKV6 calls take their plain versions, which hand B.6
and B.7 the same bfloat16 q, k, v (r, k, v, w, u) on the card.

The reference is compiled with ``xla_allow_excess_precision`` off.  With it
on (XLA's default), the compiled program keeps fused elementwise chains in
float32 where the JAX program rounds each op to bfloat16, so the result is
not the program's arithmetic: the port, which rounds where the program
does, parts from it by 2-6 bfloat16 ulps of the largest logit.

Tolerance, in bfloat16 ulps of the values compared.  The two packages take
float32 sums (the matrix products) in other orders; where a sum falls
within float32 noise of a bfloat16 rounding boundary they round to
neighbouring values, one ulp of that element, and the next layer's norm
carries the change into its whole row.  Over three token seeds (and
gemma2's swa/attn alternation with its softcaps, measured the same way and
left out for time) such flips spread to at most 1.35 ulps of a tensor's largest |value| and changed at
most 1.7 % of a bfloat16 cache leaf's elements (none at all for qwen2 and
rwkv6).  So each logit tensor and cache leaf is held within
``MAX_ULPS`` ulps of its largest |value|, and each bfloat16 leaf must be
bit-equal in at least ``MIN_EQUAL`` of its elements.  A rounding put in
another place fails the second rule: ``F.silu`` rounding once where the
reference rounds the sigmoid first (fixed in ``models/layers.py``) left
only 33-80 % of the cache bit-equal, while reaching only 1.4-2.5 ulps of the
largest |value|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import TransformerLM as RefLM
from repro.serve.prefill import merge_prefill_cache as ref_merge
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.models import TransformerLM
from repro_torch.serve import merge_prefill_cache
from repro_torch.utils.tree import flatten

ARCHS = ("qwen2_0_5b", "h2o_danube_1_8b", "rwkv6_7b")
LAYERS, B, S0, DECODES = 2, 2, 20, 3
MAX_ULPS = 2.0    # of a tensor's largest |value| (module doc)
MIN_EQUAL = 0.95  # share of a bfloat16 leaf's elements bit-equal (module doc)
# the program's arithmetic: every op rounded to its dtype (module doc)
COMPILER_OPTIONS = {"xla_allow_excess_precision": False}


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=COMPILER_OPTIONS)


def _flat_cache(cache):
    """The cache tree (a (head, groups) pair or dict) -> "a/b" leaves."""
    head, groups = cache if isinstance(cache, tuple) else (cache["head"], cache["groups"])
    out = flatten({"groups": groups})
    out.update(flatten({"head": {str(i): c for i, c in enumerate(head)}}))
    return out


def _held(got, want, what):
    """``got`` (a port tensor) against ``want`` (the reference's) at the
    module's tolerance."""
    w = np.asarray(jnp.asarray(want, jnp.float32))
    g = got.float().numpy()
    assert g.shape == w.shape, what
    largest = float(np.abs(w).max())
    ulp = 2.0 ** (np.floor(np.log2(largest)) - 7) if largest > 0 else 2.0 ** -133
    ulps = float(np.abs(g - w).max()) / ulp
    assert ulps <= MAX_ULPS, f"{what}: {ulps} bf16 ulps of max |x| = {largest}"
    if got.dtype == torch.bfloat16:
        assert str(want.dtype) == "bfloat16", f"{what}: {want.dtype}"
        equal = float((g == w).mean())
        assert equal >= MIN_EQUAL, f"{what}: only {equal:.3f} of the elements bit-equal"


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_and_decode_match_reference(arch):
    ref_cfg = dataclasses.replace(ref_get_arch(arch, smoke=True), n_layers=LAYERS,
                                  compute_dtype=jnp.bfloat16)
    cfg = dataclasses.replace(get_arch(arch, smoke=True), n_layers=LAYERS,
                              compute_dtype=torch.bfloat16)
    ref, model = RefLM(ref_cfg), TransformerLM(cfg)
    ref_params = ref.init(jax.random.PRNGKey(0))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, ref_params), device="cpu")
    toks = np.random.default_rng(1).integers(0, ref_cfg.vocab, (B, S0)).astype(np.int64)

    r_batch = {"tokens": jnp.asarray(toks, jnp.int32)}
    r_logits, r_pf = _compiled(ref.prefill, ref_params, r_batch)(ref_params, r_batch)
    with torch.inference_mode():
        logits, pf = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    assert logits.dtype == torch.float32
    _held(logits, r_logits, "prefill logits")
    want, got = _flat_cache(r_pf), _flat_cache(pf)
    assert sorted(want) == sorted(got)
    for name in want:
        _held(got[name], want[name], f"prefill cache {name}")

    r_cache = ref_merge(ref, r_pf, B, S0 + DECODES, S0)
    with torch.inference_mode():
        cache = merge_prefill_cache(model, pf, B, S0 + DECODES, S0)
    tok = np.argmax(np.asarray(r_logits), axis=-1)[:, None]
    decode = None
    for step in range(DECODES):
        args = (ref_params, jnp.asarray(tok, jnp.int32), jnp.int32(S0 + step), r_cache)
        decode = decode or _compiled(ref.decode_step, *args)
        r_logits, r_cache = decode(*args)
        with torch.inference_mode():
            logits, cache = model.decode_step(params, torch.from_numpy(tok), S0 + step, cache)
        _held(logits, r_logits, f"decode step {step} logits")
        want, got = _flat_cache(r_cache), _flat_cache(cache)
        for name in want:
            _held(got[name], want[name], f"decode step {step} cache {name}")
        tok = np.argmax(np.asarray(r_logits), axis=-1)[:, None]
