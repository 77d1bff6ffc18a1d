"""Serving scenario on the PyTorch port: static-batch generation, then the
continuous engine.

1. Static batch — ``repro_torch.serve.greedy_generate``: one prefill for the
   prompt batch (on the card, the flash-attention kernel B.6 on every
   attention layer, the WKV6 scan B.7 on every RWKV layer), then one
   sample-and-decode step per token.  Every arch family runs, including
   the recurrent ones (RWKV6 state, Jamba's mamba + KV hybrid) and the
   prefix frontends (pixtral, musicgen: the prompt teacher-forced through
   the decode path).
2. Continuous batching — ``repro_torch.serve.ServeEngine``: requests of
   mixed prompt/gen lengths arrive over time into a paged KV pool (RWKV and
   Mamba keep their recurrent states per slot); each admission runs a
   prefill, and one decode step serves every slot (token frontends only).

The port of ``examples/serve_decode.py``: the same flags, printed lines and
defaults, plus ``--device`` (the card by default; ``cpu`` runs the plain
PyTorch versions).  Differences: eager PyTorch compiles no program, so the
engine line prints the engine's decode-step count where the reference
prints its compiled programs (ROADMAP A.13); at a temperature above 0 the
tokens are drawn from a ``torch.Generator``, not JAX's random bits (at 0,
greedy, they are the reference's).  The weights come from the port's own
seeded init unless ``main`` is handed parameters.

Run:  PYTHONPATH=src python examples/torch_serve_decode.py [--arch jamba_1_5_large_398b] [--device cpu]
      (smoke-width; the arch family is what matters)
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.device import resolve_device
from repro_torch.models import TransformerLM
from repro_torch.serve import Request, ServeEngine, greedy_generate


def main(argv=None, params=None) -> dict:
    """Returns the static batch's tokens and the engine's report."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6_7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen-len", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_arch(args.arch, smoke=True)
    model = TransformerLM(cfg)
    if params is None:
        params = model.init(torch.Generator(device).manual_seed(0))
    params = {n: t.to(device) for n, t in params.items()}
    print(f"arch family={cfg.name} ({cfg.arch_type}), "
          f"params={model.num_params():,}")

    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))).to(device)

    # -- 1. static batch: prefill + sample/decode steps -----------------------
    t0 = time.time()
    gen = greedy_generate(model, params, prompt, args.gen_len,
                          temperature=args.temperature, seed=1).cpu().numpy()
    dt = time.time() - t0
    print(f"static batch: ({args.batch}, {args.gen_len}) tokens in {dt:.2f}s "
          f"(eager, no compile)")
    print("sample tokens:", gen[0][:12])

    # -- 2. continuous batching over a paged KV pool --------------------------
    if not model.has_prompt_prefill:
        print("engine demo skipped (prefix frontend)")
        return dict(tokens=gen, report=None)
    reqs = [
        Request(rid=i, prompt=rng.integers(0, cfg.vocab, (s0,)).astype(np.int32),
                max_new=n, arrival=float(arr))
        for i, (s0, n, arr) in enumerate(
            [(8, 6, 0), (16, 4, 0), (8, 8, 2), (1, 5, 4), (16, 6, 6)])
    ]
    engine = ServeEngine(model, params, max_batch=2, max_len=24, page_size=4)
    report = engine.run(reqs, clock="steps")
    print(f"engine: {report['completed']} requests through 2 slots in "
          f"{report['steps']} steps, one eager decode step "
          f"(decode steps={report['decode']['steady_steps'] + 1})")
    for c in sorted(report["completions"], key=lambda c: c.rid):
        print(f"  rid {c.rid}: s0={c.s0:2d} -> {c.n_tokens} tokens "
              f"{np.asarray(c.tokens[:6])}")
    return dict(tokens=gen, report=report)


if __name__ == "__main__":
    main()
