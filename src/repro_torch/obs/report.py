"""Run report + regression gate over the telemetry stream (CLI-facing).

The port of ``repro.obs.report``.  ``python -m repro_torch.obs report
<log-dir|telemetry.jsonl>`` folds one run's JSONL stream
(:mod:`repro_torch.obs.schema`) into the paper-facing summary:

* **fairness** — final ``acc_avg`` / worst-distribution accuracy /
  per-node accuracy STDEV and spread, plus the DR mixture-weight
  concentration (the adversarial λ* the algorithm is steering);
* **comm** — cumulative wire bytes and, with ``--target-acc``,
  bytes-to-target (the paper's communication-efficiency axis);
* **histograms** — the on-device streaming counts
  (:mod:`repro_torch.obs.hist`) aggregated over the run and rendered as
  text bars;
* **serve** — TTFT / per-token p50/p99 per traffic class and the KV-pool
  occupancy timeline, all derived from the engine's ``trace`` lifecycle
  records (:func:`serve_latency_summary` is the single latency accounting
  both this CLI and the engine's run report use);
* **events** — trainer round events (fault / EF re-base / rate switch)
  re-derived host-side via
  :func:`repro_torch.obs.trace.trainer_trace_events` from the ``meta``
  record's fault config, replayed on the run's device (the coins are the
  same on every device).

Output is terminal text or a static self-contained HTML page (``--html``).

``python -m repro_torch.obs compare <baseline> <candidate>`` diffs two runs
(log dirs / JSONL streams) or two ``BENCH_*.json`` files metric-by-metric
and **exits nonzero** when any directional metric regresses beyond the
threshold (``--max-regression`` percent, per-metric overrides via
``--metric path:pct``) — the CI regression gate.
"""

from __future__ import annotations

import html as _html
import json
import os

import numpy as np

# -- loading -------------------------------------------------------------------


def load_records(path: str) -> list[dict]:
    """Records of one run: a ``.jsonl`` stream or a log dir containing one
    (``telemetry.jsonl``, or the single ``*.jsonl`` inside)."""
    if os.path.isdir(path):
        cand = os.path.join(path, "telemetry.jsonl")
        if not os.path.exists(cand):
            js = sorted(f for f in os.listdir(path) if f.endswith(".jsonl"))
            if len(js) != 1:
                raise FileNotFoundError(
                    f"{path}: need telemetry.jsonl or exactly one *.jsonl "
                    f"(found {js})")
            cand = os.path.join(path, js[0])
        path = cand
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def _pctl(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q))


# -- serve latency (the single accounting) -------------------------------------


def serve_latency_summary(records) -> dict:
    """Latency rollup from the engine's ``finished`` trace records.

    This is THE latency accounting: :class:`repro_torch.serve.ServeEngine`
    puts it in its run report and the report CLI renders it.
    """
    fin = [r for r in records
           if r.get("kind") == "trace" and r.get("event") == "finished"]
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
    classes = sorted({r.get("cls", "?") for r in fin})
    summary["per_class"] = {
        cls: rollup([r for r in fin if r.get("cls") == cls])
        for cls in classes}
    return summary


# -- summarizing one run -------------------------------------------------------


def _fault_config_from_meta(meta: dict):
    """Rebuild the run's FaultConfig from its meta record (None if faultless
    or the config fields aren't logged)."""
    if not meta:
        return None
    sp = float(meta.get("straggler_p", 0.0) or 0.0)
    op = float(meta.get("outage_p", 0.0) or 0.0)
    if sp <= 0.0 and op <= 0.0:
        return None
    from repro_torch.dynamics.faults import FaultConfig

    return FaultConfig(
        link_drop_p=0.0, straggler_p=sp, outage_p=op,
        outage_len=int(meta.get("outage_len", 10) or 10),
        seed=int(meta.get("seed", 0) or 0))


def derive_trainer_events(records, meta: dict) -> list[dict]:
    """Host-side trainer trace events of a run (fault replay on the meta
    record's ``device`` + EF re-base + rate switches) — see
    :func:`repro_torch.obs.trace.trainer_trace_events`."""
    from repro_torch.obs.trace import trainer_trace_events

    return trainer_trace_events(
        records,
        faults=_fault_config_from_meta(meta),
        num_nodes=int(meta["nodes"]) if meta.get("nodes") else None,
        ef_rebase_every=int(meta.get("ef_rebase_every", 0) or 0),
        ef_rebase_threshold=float(meta.get("ef_rebase_threshold", 0.0) or 0.0),
        topology=str(meta.get("topology", "static")),
        device=str(meta.get("device", "cuda")))


def summarize_run(records, *, target_acc: float | None = None,
                  derive_events: bool = True) -> dict:
    """Fold one run's records into the report summary dict (all sections
    optional — a serve-only or train-only stream renders fine)."""
    by = {}
    for r in records:
        by.setdefault(r.get("kind", "?"), []).append(r)
    meta = dict(by.get("meta", [{}])[0])
    for k in ("v", "kind", "step"):
        meta.pop(k, None)
    summary: dict = {"meta": meta}

    train = by.get("train", [])
    if train:
        steps = [r["step"] for r in train]
        last = train[-1]
        cum_bytes = float(sum(r.get("comm_bytes", 0.0) for r in train))
        summary["train"] = {
            "records": len(train),
            "step_min": min(steps), "step_max": max(steps),
            "final_loss_mean": last["loss_mean"],
            "final_loss_worst": last["loss_worst"],
            "final_robust_objective": last["robust_objective"],
            "cumulative_wire_bytes": cum_bytes,
        }
        dr_rec = next((r for r in reversed(train) if "dr_weights" in r), None)
        if dr_rec is not None:
            lam = np.asarray(dr_rec["dr_weights"], np.float64)
            summary["dr_weights"] = {
                "step": dr_rec["step"],
                "max": float(lam.max()), "min": float(lam.min()),
                "std": float(lam.std()),
            }

    evals = by.get("eval", [])
    if evals:
        last = evals[-1]
        fairness = {
            "acc_avg": last["acc_avg"],
            "acc_worst_dist": last["acc_worst_dist"],
            "acc_node_std": last["acc_node_std"],
        }
        nodes = last.get("acc_nodes")
        if nodes:
            fairness["acc_spread"] = float(max(nodes) - min(nodes))
        if target_acc is not None and train:
            # cumulative wire bytes at the first eval that reaches target
            fairness["target_acc"] = float(target_acc)
            hit = next((e for e in evals if e["acc_avg"] >= target_acc), None)
            if hit is not None:
                fairness["bytes_to_target"] = float(sum(
                    r.get("comm_bytes", 0.0) for r in train
                    if r["step"] <= hit["step"]))
        summary["fairness"] = fairness

    hists = {}
    for r in train:
        for k, v in r.items():
            if k.startswith("hist_") and isinstance(v, list):
                agg = hists.setdefault(k, np.zeros(len(v), np.int64))
                agg += np.asarray(v, np.int64)
    if hists:
        summary["histograms"] = {k: [int(x) for x in v]
                                 for k, v in sorted(hists.items())}

    perf = by.get("perf", [])
    if perf:
        summary["perf"] = {
            "steps_per_s": float(np.mean([r["steps_per_s"] for r in perf])),
            "wall_s": float(sum(r.get("wall_s", 0.0) for r in perf)),
        }

    serve = by.get("serve", [])
    if serve:
        last = serve[-1]
        occ = [(r["step"], r["kv_occupancy"]) for r in serve]
        summary["serve"] = {
            "steps": last["step"],
            "admitted": last.get("admitted", 0),
            "completed": last.get("completed", 0),
            "kv_occupancy_max": float(max(o for _, o in occ)),
            "kv_occupancy_timeline": occ,
            "decode_tok_s": float(last.get("decode_tok_s", 0.0)),
        }

    traces = by.get("trace", [])
    if derive_events and train:
        try:
            traces = traces + derive_trainer_events(records, meta)
        except Exception as e:          # replay is best-effort in the report
            summary["events_error"] = str(e)
    if traces:
        counts: dict[str, int] = {}
        for r in traces:
            counts[r.get("event", "?")] = counts.get(r.get("event", "?"), 0) + 1
        summary["events"] = dict(sorted(counts.items()))
        summary["trace_records"] = traces
        lat = serve_latency_summary(traces)
        if lat["requests"]:
            summary["latency"] = lat
    return summary


# -- text rendering ------------------------------------------------------------

_BAR = "▏▎▍▌▋▊▉█"


def _bar(n: int, peak: int, width: int = 24) -> str:
    if peak <= 0:
        return ""
    frac = n / peak * width
    full, rem = int(frac), frac - int(frac)
    return "█" * full + (_BAR[int(rem * 8)] if rem > 1 / 16 else "")


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.4g}" if (v == 0 or 1e-3 <= abs(v) < 1e5) else f"{v:.3e}"
    return str(v)


def render_text(summary: dict) -> str:
    lines: list[str] = []

    def sec(title):
        lines.append(f"== {title} ==")

    def kv(d, skip=()):
        for k, v in d.items():
            if k not in skip:
                lines.append(f"  {k} = {_fmt(v)}")

    if summary.get("meta"):
        sec("meta")
        kv(summary["meta"])
    for name in ("train", "fairness", "dr_weights", "perf"):
        if name in summary:
            sec(name)
            kv(summary[name])
    if "histograms" in summary:
        sec("histograms")
        from repro_torch.obs.hist import TRAIN_HISTOGRAMS

        grids = {f"hist_{s.source}": s for s in TRAIN_HISTOGRAMS}
        for name, counts in summary["histograms"].items():
            spec = grids.get(name)
            total, peak = sum(counts), max(counts)
            rng = (f" range=[{_fmt(spec.lo)}, {_fmt(spec.hi)}]"
                   + (" log10" if spec.log10 else "")) if spec else ""
            lines.append(f"  {name}  n={total}{rng}")
            for i, n in enumerate(counts):
                if spec:
                    lo = spec.lo + (spec.hi - spec.lo) * i / spec.bins
                    hi = spec.lo + (spec.hi - spec.lo) * (i + 1) / spec.bins
                    label = f"[{lo:7.3f},{hi:7.3f})"
                else:
                    label = f"bin {i:2d}"
                lines.append(f"    {label} {n:8d} {_bar(n, peak)}")
    if "serve" in summary:
        sec("serve")
        kv(summary["serve"], skip=("kv_occupancy_timeline",))
        tl = summary["serve"].get("kv_occupancy_timeline") or []
        if tl:
            peak = max(o for _, o in tl) or 1.0
            pts = tl[:: max(1, len(tl) // 16)]
            lines.append("  kv occupancy timeline:")
            for step, occ in pts:
                lines.append(f"    step {step:6d} {occ:6.2f} "
                             f"{_bar(int(occ * 1000), int(peak * 1000))}")
    if "latency" in summary:
        sec("latency")
        kv(summary["latency"], skip=("per_class",))
        for cls, d in summary["latency"].get("per_class", {}).items():
            lines.append(f"  class {cls}:")
            for k, v in d.items():
                lines.append(f"    {k} = {_fmt(v)}")
    if "events" in summary:
        sec("events")
        kv(summary["events"])
    if "events_error" in summary:
        lines.append(f"  (event derivation failed: {summary['events_error']})")
    return "\n".join(lines) + "\n"


# -- HTML rendering ------------------------------------------------------------


def _spark(points, width=480, height=60) -> str:
    """Inline SVG sparkline of (x, y) points (self-contained, no deps)."""
    if len(points) < 2:
        return ""
    xs = [float(x) for x, _ in points]
    ys = [float(y) for _, y in points]
    x0, x1 = min(xs), max(xs) or 1.0
    y0, y1 = min(ys), max(ys)
    sx = (width - 4) / ((x1 - x0) or 1.0)
    sy = (height - 4) / ((y1 - y0) or 1.0)
    pts = " ".join(f"{2 + (x - x0) * sx:.1f},{height - 2 - (y - y0) * sy:.1f}"
                   for x, y in zip(xs, ys))
    return (f'<svg width="{width}" height="{height}">'
            f'<polyline fill="none" stroke="#36c" stroke-width="1.5" '
            f'points="{pts}"/></svg>')


def render_html(summary: dict, records=None, title: str = "repro_torch run report"
                ) -> str:
    parts = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        f"<title>{_html.escape(title)}</title>",
        "<style>body{font:14px/1.5 system-ui,sans-serif;margin:2em;"
        "max-width:60em}h2{border-bottom:1px solid #ccc}"
        "table{border-collapse:collapse}td,th{padding:2px 10px;"
        "text-align:left;border-bottom:1px solid #eee}"
        "pre{background:#f6f6f6;padding:1em;overflow-x:auto}</style>",
        f"</head><body><h1>{_html.escape(title)}</h1>",
    ]

    def table(d: dict):
        parts.append("<table>")
        for k, v in d.items():
            parts.append(f"<tr><th>{_html.escape(str(k))}</th>"
                         f"<td>{_html.escape(_fmt(v))}</td></tr>")
        parts.append("</table>")

    for name in ("meta", "train", "fairness", "dr_weights", "perf"):
        if summary.get(name):
            parts.append(f"<h2>{name}</h2>")
            table(summary[name])
    if records:
        tr = [(r["step"], r["loss_mean"]) for r in records
              if r.get("kind") == "train"]
        if len(tr) > 1:
            parts.append("<h2>loss_mean</h2>" + _spark(tr))
        wd = [(r["step"], r["loss_worst"]) for r in records
              if r.get("kind") == "train"]
        if len(wd) > 1:
            parts.append("<h2>loss_worst</h2>" + _spark(wd))
    if "histograms" in summary:
        parts.append("<h2>histograms</h2><pre>")
        text = render_text({"histograms": summary["histograms"]})
        parts.append(_html.escape(text))
        parts.append("</pre>")
    if "serve" in summary:
        parts.append("<h2>serve</h2>")
        table({k: v for k, v in summary["serve"].items()
               if k != "kv_occupancy_timeline"})
        tl = summary["serve"].get("kv_occupancy_timeline") or []
        if len(tl) > 1:
            parts.append("<h3>KV occupancy</h3>" + _spark(tl))
    if "latency" in summary:
        parts.append("<h2>latency</h2>")
        table({k: v for k, v in summary["latency"].items()
               if k != "per_class"})
        for cls, d in summary["latency"].get("per_class", {}).items():
            parts.append(f"<h3>class {_html.escape(cls)}</h3>")
            table(d)
    if "events" in summary:
        parts.append("<h2>events</h2>")
        table(summary["events"])
    parts.append("</body></html>")
    return "".join(parts)


# -- compare: the regression gate ----------------------------------------------


def flatten_metrics(obj, prefix: str = "") -> dict[str, float]:
    """Numeric leaves of a nested dict as dotted paths (lists are skipped —
    timelines and vectors aren't gateable point metrics)."""
    out: dict[str, float] = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            out.update(flatten_metrics(v, f"{prefix}{k}."))
    elif isinstance(obj, bool):
        pass
    elif isinstance(obj, (int, float)):
        out[prefix[:-1]] = float(obj)
    return out


#: substrings marking a metric where HIGHER is better (checked first)
_HIGHER = ("per_s", "tok_s", "steps_per_s", "acc")
#: substrings marking a metric where LOWER is better
_LOWER = ("ttft", "per_token", "overhead", "_pct", "_ms", "_s", "bytes",
          "loss", "queued", "wall", "compile")


def metric_direction(path: str) -> int:
    """+1 higher-better, -1 lower-better, 0 not gateable."""
    if path.startswith("meta."):
        return 0                       # run config, not a quality metric
    leaf = path.rsplit(".", 1)[-1]
    if "budget" in leaf:
        return 0                       # asserted ceiling, not a measurement
    # dispersion beats the "acc" prefix: acc_node_std / acc_spread are
    # fairness metrics where LOWER is better
    if "std" in leaf or "spread" in leaf:
        return -1
    if any(p in leaf for p in _HIGHER):
        return 1
    if any(p in leaf for p in _LOWER):
        return -1
    return 0


def compare_metrics(base: dict, cand: dict, *, max_regression_pct: float,
                    overrides: dict[str, float] | None = None) -> dict:
    """Diff two flattened metric dicts; a *regression* is a move in the bad
    direction beyond the threshold (percent of the baseline value).

    ``overrides`` maps metric paths to per-metric thresholds; when given and
    non-empty, ONLY those paths are gated (everything else is informational).
    """
    overrides = overrides or {}
    rows, regressions = [], []
    for path in sorted(set(base) & set(cand)):
        a, b = base[path], cand[path]
        direction = metric_direction(path)
        thresh = overrides.get(path, max_regression_pct)
        gated = path in overrides if overrides else direction != 0
        reg_pct = None
        if direction != 0 and abs(a) > 1e-12:
            reg_pct = (a - b) / abs(a) * 100 * direction
        bad = gated and reg_pct is not None and reg_pct > thresh
        rows.append({"metric": path, "base": a, "cand": b,
                     "direction": direction, "regression_pct": reg_pct,
                     "gated": gated, "regressed": bad})
        if bad:
            regressions.append(rows[-1])
    return {"rows": rows, "regressions": regressions,
            "only_base": sorted(set(base) - set(cand)),
            "only_cand": sorted(set(cand) - set(base))}


def load_metrics(path: str) -> dict[str, float]:
    """Flattened metrics of a comparand: a ``BENCH_*.json`` dict, or a run
    (log dir / JSONL) summarized first."""
    if os.path.isfile(path) and path.endswith(".json"):
        with open(path) as f:
            return flatten_metrics(json.load(f))
    summary = summarize_run(load_records(path), derive_events=False)
    summary.pop("trace_records", None)
    return flatten_metrics(summary)


def render_compare(result: dict, verbose: bool = False) -> str:
    lines = []
    for row in result["rows"]:
        if not verbose and not row["gated"]:
            continue
        arrow = {1: "↑good", -1: "↓good", 0: ""}[row["direction"]]
        reg = (f"{row['regression_pct']:+7.2f}%"
               if row["regression_pct"] is not None else "      —")
        mark = " REGRESSION" if row["regressed"] else ""
        lines.append(f"  {row['metric']:<48s} {_fmt(row['base']):>12s} -> "
                     f"{_fmt(row['cand']):>12s}  {reg} {arrow}{mark}")
    n = len(result["regressions"])
    lines.append(f"{n} regression(s)" if n else "no regressions")
    return "\n".join(lines) + "\n"


# -- CLI -----------------------------------------------------------------------


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="run report + regression gate over repro_torch telemetry")
    sub = ap.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser("report", help="summarize one run's telemetry")
    rp.add_argument("path", help="log dir or telemetry JSONL")
    rp.add_argument("--html", default=None, metavar="OUT",
                    help="also write a static HTML report")
    rp.add_argument("--target-acc", type=float, default=None,
                    help="report cumulative wire bytes to this accuracy")
    rp.add_argument("--export-trace", default=None, metavar="OUT",
                    help="write trace events as Chrome trace-event JSON "
                         "(.gz ok); merged onto the run's --profile trace "
                         "when one is found in the log dir")
    rp.add_argument("--json", action="store_true",
                    help="print the summary as JSON instead of text")

    cp = sub.add_parser("compare",
                        help="diff two runs / BENCH json files; exit 1 on "
                             "regression beyond threshold")
    cp.add_argument("baseline")
    cp.add_argument("candidate")
    cp.add_argument("--max-regression", type=float, default=10.0,
                    metavar="PCT", help="default threshold (percent)")
    cp.add_argument("--metric", action="append", default=[],
                    metavar="PATH[:PCT]",
                    help="gate only this metric (repeatable), optionally "
                         "with its own threshold")
    cp.add_argument("--verbose", action="store_true",
                    help="also print non-gated metrics")
    args = ap.parse_args(argv)

    if args.cmd == "report":
        records = load_records(args.path)
        summary = summarize_run(records, target_acc=args.target_acc)
        traces = summary.pop("trace_records", [])
        if args.json:
            print(json.dumps(summary, indent=2))
        else:
            print(render_text(summary), end="")
        if args.html:
            with open(args.html, "w") as f:
                f.write(render_html(summary, records))
            print(f"html report -> {args.html}")
        if args.export_trace:
            from repro_torch.obs.profiler import find_perfetto_trace
            from repro_torch.obs.trace import export_chrome_trace, merge_with_profile

            prof = (find_perfetto_trace(args.path)
                    if os.path.isdir(args.path) else None)
            if prof:
                merge_with_profile(traces, prof, args.export_trace)
                print(f"trace (merged onto {prof}) -> {args.export_trace}")
            else:
                export_chrome_trace(traces, args.export_trace)
                print(f"trace -> {args.export_trace}")
        return 0

    overrides: dict[str, float] = {}
    for spec in args.metric:
        path, _, pct = spec.partition(":")
        overrides[path] = float(pct) if pct else args.max_regression
    result = compare_metrics(
        load_metrics(args.baseline), load_metrics(args.candidate),
        max_regression_pct=args.max_regression, overrides=overrides)
    print(f"compare {args.baseline} -> {args.candidate} "
          f"(threshold {args.max_regression:g}%)")
    print(render_compare(result, verbose=args.verbose), end="")
    return 1 if result["regressions"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
