"""The serving engine's latency summary (the port of
``repro.obs.report.serve_latency_summary`` and its percentile helper)."""

from __future__ import annotations

import numpy as np


def _pctl(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q))


def serve_latency_summary(records) -> dict:
    """Latency rollup from the engine's ``finished`` trace records: the
    requests, tokens, median queueing, TTFT p50/p99 and per-token p50/p99
    (requests of more than one token), overall and per class."""
    fin = [r for r in records if r.get("kind") == "trace" and r.get("event") == "finished"]
    if not fin:
        return {"requests": 0}

    def rollup(rs) -> dict:
        ttft = [r["ttft_s"] for r in rs]
        tok = [r["per_token_s"] for r in rs if r.get("tokens", 0) > 1]
        out = {
            "requests": len(rs),
            "tokens": int(sum(r.get("tokens", 0) for r in rs)),
            "queued_p50_s": _pctl([r.get("queued_s", 0.0) for r in rs], 50),
            "ttft_p50_s": _pctl(ttft, 50),
            "ttft_p99_s": _pctl(ttft, 99),
        }
        if tok:
            out["per_token_p50_s"] = _pctl(tok, 50)
            out["per_token_p99_s"] = _pctl(tok, 99)
        return out

    summary = rollup(fin)
    summary["per_class"] = {cls: rollup([r for r in fin if r.get("cls") == cls])
                            for cls in sorted({r.get("cls", "?") for r in fin})}
    return summary
