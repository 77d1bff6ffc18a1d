"""How far do a random-weight RWKV6's prefill and decode-only paths part with depth?

Both packages, on the CPU: the rwkv6 smoke config widened to d = 256 (four
heads of 64, d_ff 896) at 2, 8, 16 and 32 layers, seeded weights (the
reference's ``init(PRNGKey(0))``, carried into the port), batch 2, a
64-token prompt.  For each depth it prints the largest difference between
the prompt's last logits from ``prefill`` and from feeding the prompt token
by token through ``decode_step``, relative to the largest logit.  The two
paths compute the same function in another float32 order; a growing gap
says the function amplifies rounding, whatever computes it.

  PYTHONPATH=src python tests/rwkv_depth_sweep.py

Takes about a minute.  Not collected by pytest.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

DEPTHS = (2, 8, 16, 32)
WIDE = dict(d_model=256, rwkv_head_dim=64, d_ff=896)


def main() -> int:
    import jax
    import jax.numpy as jnp
    import torch

    from repro.configs import get_arch as ref_get_arch
    from repro.models import TransformerLM as RefLM
    from repro_torch import convert
    from repro_torch.configs import get_arch
    from repro_torch.models import TransformerLM

    for n in DEPTHS:
        ref = RefLM(dataclasses.replace(ref_get_arch("rwkv6_7b", smoke=True), n_layers=n,
                                        **WIDE))
        port = TransformerLM(dataclasses.replace(get_arch("rwkv6_7b", smoke=True),
                                                 n_layers=n, **WIDE))
        params = ref.init(jax.random.PRNGKey(0))
        prompt = np.random.default_rng(0).integers(0, ref.cfg.vocab, (2, 64))
        tokens = jnp.asarray(prompt, jnp.int32)
        pre, _ = jax.jit(ref.prefill)(params, {"tokens": tokens})
        decode, cache = jax.jit(ref.decode_step), ref.init_cache(2, 64)
        for t in range(64):
            dec, cache = decode(params, tokens[:, t:t + 1], jnp.int32(t), cache)
        ref_gap = float(jnp.abs(pre - dec).max() / jnp.abs(dec).max())

        p = convert.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
        toks = torch.from_numpy(prompt)
        with torch.inference_mode():
            pre_t, _ = port.prefill(p, {"tokens": toks})
            cache_t = port.init_cache(2, 64, "cpu")
            for t in range(64):
                dec_t, cache_t = port.decode_step(p, toks[:, t:t + 1], t, cache_t)
        port_gap = float((pre_t - dec_t).abs().max() / dec_t.abs().max())
        print(json.dumps({"layers": n, "reference_rel_gap": ref_gap, "port_rel_gap": port_gap}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
