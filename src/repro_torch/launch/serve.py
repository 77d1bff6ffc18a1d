"""Serving CLI on one GPU: static-batch generation or the
continuous-batching engine (the port of ``repro.launch.serve``).

* default: :func:`timed_generate` runs one prompt batch through
  ``prefill`` (B.6 on every attn/swa layer, B.7 on every rwkv layer; the
  stub frontends feed it through the decode path) and then decodes, sampling from the previous logits each step, with honest
  throughput numbers: the first call and steady state are reported apart,
  prefill and decode each get their own tok/s, and prompt tokens are never
  counted as generated.
* ``--engine``: a :class:`repro_torch.serve.ServeEngine` over an open-loop
  Poisson trace of ``SMOKE_CLASSES`` (``--rate`` requests per clock unit
  until ``--horizon``), ``--batch`` slots over a paged KV pool of
  ``--page-size`` tokens per page, int8 with ``--int8-kv`` (B.2 writes
  every KV row on the card).  The clock is decode steps with ``--smoke``,
  wall seconds otherwise, as in the reference.

Weights come from the port's own seeded init on the device.  ``--log-dir``
gives the engine a :class:`repro_torch.obs.MetricsSink` writing
``<log-dir>/telemetry.jsonl`` (its request lifecycle and heartbeat records);
the static path ignores it, as the reference's does.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_0_5b \
      --batch 4 --prompt-len 512 --gen-len 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_0_5b \
      --engine --int8-kv --rate 2.0 --horizon 8 --log-dir runs/serve
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6_7b --smoke \
      --engine --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.device import resolve_device
from repro_torch.models import TransformerLM
from repro_torch.serve.prefill import merge_prefill_cache
from repro_torch.serve.sampling import sample_tokens


def _clock(device: torch.device) -> float:
    """Host seconds, after the device's queued work is done."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.monotonic()


@torch.inference_mode()
def timed_generate(model: TransformerLM, params: dict, prompt: torch.Tensor,
                   gen_len: int, temperature: float = 0.0, seed: int = 0,
                   use_prefill: bool = True):
    """:func:`repro_torch.serve.greedy_generate` with phase accounting.

    Returns ``(tokens (B, gen_len), stats)``, the reference's stats keys:
    per phase (``prefill``, ``decode``) the first call's extra seconds over
    a steady one (``compile_s``: kernel build and load, allocator warm-up;
    the port compiles nothing per shape), the steady seconds, the tokens
    that phase processed and their rate.  The prefill runs twice on the
    same prompt, and the second call's outputs are the ones used.  The stub
    frontends (and ``use_prefill=False``) feed the prompt through the
    decode path, one token per step, as the reference does.
    """
    dev = prompt.device
    b, s0 = prompt.shape
    cache_len = s0 + gen_len
    stats = {"prefill": {"compile_s": 0.0, "steady_s": 0.0, "tokens": 0},
             "decode": {"compile_s": 0.0, "steady_s": 0.0, "tokens": 0}}

    if use_prefill and model.has_prompt_prefill:
        t0 = _clock(dev)
        model.prefill(params, {"tokens": prompt})
        t1 = _clock(dev)
        logits, pf = model.prefill(params, {"tokens": prompt})
        t2 = _clock(dev)
        stats["prefill"] = {"compile_s": max(0.0, (t1 - t0) - (t2 - t1)),
                            "steady_s": t2 - t1, "tokens": b * s0}
        cache = merge_prefill_cache(model, pf, b, cache_len, s0)
    else:
        cache = model.init_cache(b, cache_len, dev)
        logits = None
        t0 = t1 = _clock(dev)
        for t in range(s0):
            logits, cache = model.decode_step(params, prompt[:, t:t + 1], t, cache)
            if t == 0:
                t1 = _clock(dev)
        t2 = _clock(dev)
        stats["prefill"] = {"compile_s": t1 - t0, "steady_s": t2 - t1,
                            "tokens": b * max(0, s0 - 1)}

    gen = torch.Generator(device=dev).manual_seed(seed)
    temp = torch.full((b,), temperature, dtype=torch.float32, device=dev)
    outs = []
    t0 = t1 = _clock(dev)
    for t in range(gen_len):
        tok = sample_tokens(logits, gen, temp)
        logits, cache = model.decode_step(params, tok[:, None], s0 + t, cache)
        outs.append(tok)
        if t == 0:
            t1 = _clock(dev)
    out = torch.stack(outs, dim=1)
    t2 = _clock(dev)
    stats["decode"] = {"compile_s": t1 - t0 if gen_len else 0.0,
                       "steady_s": t2 - t1 if gen_len else 0.0,
                       "tokens": b * max(0, gen_len - 1)}
    for ph in stats.values():
        ph["tok_s"] = ph["tokens"] / ph["steady_s"] if ph["steady_s"] else 0.0
    return out, stats


def _run_static(args, model, params, cfg, device) -> None:
    rng = np.random.default_rng(args.seed)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
                              ).to(device)
    out, stats = timed_generate(model, params, prompt, args.gen_len, args.temperature,
                                args.seed, use_prefill=not args.no_prefill)
    pf, dc = stats["prefill"], stats["decode"]
    print(f"generated {tuple(out.shape)}")
    print(f"prefill: {pf['tokens']} prompt tok, first call +{pf['compile_s']:.2f}s,"
          f" steady {pf['steady_s']:.3f}s -> {pf['tok_s']:.1f} tok/s")
    print(f"decode:  {dc['tokens']} new tok,    first call +{dc['compile_s']:.2f}s,"
          f" steady {dc['steady_s']:.3f}s -> {dc['tok_s']:.1f} tok/s")
    print("sample:", out[0][:16].cpu().numpy())


def _run_engine(args, model, params, cfg) -> dict:
    from repro_torch.obs import MetricsSink
    from repro_torch.serve import SMOKE_CLASSES, ServeEngine, poisson_trace

    # the context bound comes from the traffic classes' worst case, not --prompt-len
    max_len = max(c.prompt_len + c.gen_max for c in SMOKE_CLASSES)
    engine = ServeEngine(model, params, max_batch=args.batch, max_len=max_len,
                         page_size=args.page_size, quantized=args.int8_kv, seed=args.seed,
                         sink=MetricsSink(args.log_dir) if args.log_dir else None,
                         log_every=args.log_every)
    trace = poisson_trace(SMOKE_CLASSES, rate=args.rate, horizon=args.horizon, vocab=cfg.vocab,
                          seed=args.seed)
    report = engine.run(trace, clock="steps" if args.smoke else "wall")
    dc = report["decode"]
    print(f"engine: {report['completed']}/{report['admitted']} requests, "
          f"{report['steps']} steps in {report['wall_s']:.2f}s")
    print(f"decode: first call +{dc['compile_s']:.2f}s, steady {dc['steady_s']:.3f}s -> "
          f"{dc['tok_s']:.1f} tok/s ({dc['steady_tokens']} tok)")
    lat = report["latency"]
    if lat["requests"]:
        line = f"latency: ttft p50 {lat['ttft_p50_s']:.3f}s p99 {lat['ttft_p99_s']:.3f}s"
        if "per_token_p50_s" in lat:
            line += (f", per-token p50 {lat['per_token_p50_s'] * 1e3:.1f}ms "
                     f"p99 {lat['per_token_p99_s'] * 1e3:.1f}ms")
        print(line)
        for cls, d in lat["per_class"].items():
            print(f"  class {cls}: {d['requests']} req, "
                  f"ttft p50 {d['ttft_p50_s']:.3f}s p99 {d['ttft_p99_s']:.3f}s")
    engine.sink.close()
    if engine.sink.path:
        print(f"telemetry: {engine.sink.path}")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-prefill", action="store_true",
                    help="force the token-by-token decode-path prompt loop")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--engine", action="store_true",
                    help="continuous-batching engine over a Poisson trace")
    ap.add_argument("--rate", type=float, default=1.0,
                    help="engine: arrivals per clock unit")
    ap.add_argument("--horizon", type=float, default=16.0,
                    help="engine: trace length in clock units")
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--int8-kv", action="store_true")
    ap.add_argument("--log-dir", default=None,
                    help="engine: write its telemetry JSONL into this directory")
    ap.add_argument("--log-every", type=int, default=16)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch, smoke=args.smoke)
    model = TransformerLM(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    print(f"serving {cfg.name}: {model.num_params():,} params, batch={args.batch} "
          f"engine={args.engine} on {device}")
    if args.engine:
        return _run_engine(args, model, params, cfg)
    return _run_static(args, model, params, cfg, device)


if __name__ == "__main__":
    main()
