"""Structured span/event tracing: the ``trace`` record kind and its exports.

The port of ``repro.obs.trace``.  Two producers, one consumer:

* **Serve**: :class:`repro_torch.serve.ServeEngine` emits the per-request
  lifecycle — ``queued`` → ``admitted`` → ``prefill`` → ``first_token`` →
  ``finished`` — from its host-side admission and completion paths.
  ``finished`` carries the full completion accounting (class,
  ``queued_s``, ``ttft_s``, ``per_token_s``, tokens, page reservation),
  which makes the engine the single source of latency truth.

* **Train**: per-round events are *derived* on the host after the run by
  :func:`trainer_trace_events` — the fault process is a pure function of
  (seed, round), so link-drop/straggler/outage masks replay exactly from
  the :class:`~repro_torch.dynamics.FaultConfig` in the ``meta`` record,
  EF re-base firings come from the tapped ``ef_rounds``/``ef_drift``
  counters, and codec rate switches from the per-round ``wire_bits``.
  The replay runs :func:`repro_torch.dynamics.faults.replay_fault_masks`
  on the device it is given (the run's, by default): the fault coins are
  Philox draws that give the same bits on every device, so a card run's
  masks replay on the CPU too (``device="cpu"``).  A device that is not
  there raises; nothing falls back to another.

Consumers render the events as text (``python -m repro_torch.obs report``)
or as Chrome/perfetto trace-event JSON (:func:`export_chrome_trace`),
optionally merged onto the timeline a ``--profile`` run wrote
(:func:`merge_with_profile` + :func:`repro_torch.obs.find_perfetto_trace`)
so host-side request churn and device phases share one track view.
"""

from __future__ import annotations

import gzip
import json

import numpy as np

TRACE_KIND = "trace"

#: serve request lifecycle, in order
SERVE_EVENTS = ("queued", "admitted", "prefill", "first_token", "finished")
#: trainer round events derived host-side
TRAIN_EVENTS = ("fault", "ef_rebase", "rate_switch")


# -- trainer event derivation --------------------------------------------------

def trainer_trace_events(records, *, faults=None, num_nodes: int | None = None,
                         ef_rebase_every: int = 0,
                         ef_rebase_threshold: float = 0.0,
                         topology: str = "static", device="cuda") -> list[dict]:
    """Derive per-round ``trace`` events from a run's train records.

    ``records`` is any record iterable (non-``train`` kinds are ignored).
    ``faults`` is the run's :class:`~repro_torch.dynamics.FaultConfig` (or
    None); ``num_nodes`` sizes the replay (defaults to ``len(loss_nodes)``
    of the first record that has one); ``device`` is where the replay runs
    (the ``meta`` record's ``device`` by default; the coins are the same on
    every device, so a card run replays on the CPU as well).  Returned
    events are schema-valid ``trace`` records;
    ``step`` is the optimizer step (== ``CommState.rounds``).

    ``rate_switch`` events are only derived when the live link set is
    constant (``topology == "static"`` and no faults): with links coming
    and going, ``wire_bits`` moves with the link count every round and a
    codec rate change is not identifiable from the stream alone.
    """
    from repro_torch.obs.schema import SCHEMA_VERSION

    train = [r for r in records if r.get("kind") == "train"]
    events: list[dict] = []

    def ev(step, event, **fields):
        events.append({"v": SCHEMA_VERSION, "kind": TRACE_KIND,
                       "step": int(step), "event": event, **fields})

    if faults is not None and getattr(faults, "enabled", False) and train:
        k = num_nodes
        if k is None:
            k = next((len(r["loss_nodes"]) for r in train
                      if "loss_nodes" in r), None)
        if k is None:
            raise ValueError("num_nodes required to replay fault masks "
                             "(no loss_nodes vector in the records)")
        from repro_torch.dynamics.faults import replay_fault_masks

        steps = [r["step"] for r in train]
        keep, up = replay_fault_masks(faults, steps, k, device)
        iu = np.triu_indices(k, 1)
        for i, step in enumerate(steps):
            down_nodes = np.nonzero(up[i] < 0.5)[0]
            links_down = int(np.sum(keep[i][iu] < 0.5))
            if links_down or down_nodes.size:
                ev(step, "fault", links_down=links_down,
                   nodes_down=int(down_nodes.size),
                   down_nodes=[int(n) for n in down_nodes])

    # EF re-base firings: ef_rounds ticks once per consensus round and the
    # mixer re-bases on rounds where (entry ef_rounds) % B == B - 1, i.e.
    # the *post*-round counter in the record is a positive multiple of B.
    # Adaptive threshold mode fires when the previous round's drift proxy
    # exceeded the threshold.
    prev_drift = None
    for r in train:
        er = r.get("ef_rounds")
        if er is not None:
            if ef_rebase_threshold > 0:
                if prev_drift is not None and prev_drift > ef_rebase_threshold:
                    ev(r["step"], "ef_rebase", ef_rounds=int(er),
                       ef_drift=float(prev_drift))
            elif ef_rebase_every > 0 and er > 0 \
                    and er % ef_rebase_every == 0:
                ev(r["step"], "ef_rebase", ef_rounds=int(er))
        prev_drift = r.get("ef_drift")

    # codec rate switches: wire_bits is "bits injected by the last round";
    # on a constant link set, a change between consecutive communicating
    # rounds is a rate move
    links_constant = (topology == "static"
                      and (faults is None
                           or not getattr(faults, "enabled", False)))
    prev_bits = None
    for r in train if links_constant else ():
        bits = r.get("wire_bits", 0.0)
        if bits <= 0.0:
            continue
        if prev_bits is not None and bits != prev_bits:
            ev(r["step"], "rate_switch", wire_bits_old=float(prev_bits),
               wire_bits_new=float(bits))
        prev_bits = bits

    events.sort(key=lambda e: (e["step"], e["event"]))
    return events


# -- Chrome trace-event export -------------------------------------------------

#: synthetic microseconds per optimizer step for index-clock trainer events
#: (the records carry no per-step wall time; the ruler keeps rounds readable
#: next to each other, not aligned to real device time)
_STEP_US = 1000.0


def to_chrome_events(records, *, t0_us: float = 0.0,
                     pid: str = "repro_torch.obs.trace") -> list[dict]:
    """``trace`` records → Chrome trace-event JSON objects.

    Serve lifecycle events carry run-relative ``t_s`` wall timestamps and
    map to instant ("i") events — plus one complete ("X") span per finished
    request covering admit → done on its slot's track.  Trainer round
    events have no wall clock; they land on an index ruler of
    ``_STEP_US`` µs per optimizer step.  ``t0_us`` offsets everything
    (used to align onto a profile's timestamps).
    """
    out = []
    for r in records:
        if r.get("kind") != TRACE_KIND:
            continue
        event = r["event"]
        args = {k: v for k, v in r.items()
                if k not in ("v", "kind", "event")}
        if "t_s" in r:   # serve: wall-clocked
            ts = t0_us + float(r["t_s"]) * 1e6
            tid = f"slot{r['slot']}" if "slot" in r else "queue"
            cat = "serve"
            if event == "finished" and "dur_s" in r:
                out.append({"name": f"req{r.get('rid', '?')}:{r.get('cls', '')}",
                            "ph": "X", "ts": ts - float(r["dur_s"]) * 1e6,
                            "dur": float(r["dur_s"]) * 1e6,
                            "pid": pid, "tid": tid, "cat": cat, "args": args})
            out.append({"name": event, "ph": "i", "ts": ts, "s": "t",
                        "pid": pid, "tid": tid, "cat": cat, "args": args})
        else:            # trainer: index-clocked
            ts = t0_us + float(r["step"]) * _STEP_US
            out.append({"name": event, "ph": "i", "ts": ts, "s": "t",
                        "pid": pid, "tid": event, "cat": "train",
                        "args": args})
    return out


def _write_trace_json(obj: dict, path: str) -> str:
    if path.endswith(".gz"):
        with gzip.open(path, "wt") as f:
            json.dump(obj, f)
    else:
        with open(path, "w") as f:
            json.dump(obj, f)
    return path


def _read_trace_json(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        obj = json.load(f)
    if isinstance(obj, list):        # bare event-array form
        obj = {"traceEvents": obj}
    return obj


def export_chrome_trace(records, path: str) -> str:
    """Write ``trace`` records as a standalone Chrome trace-event file
    (open at https://ui.perfetto.dev; ``.gz`` suffix gzips)."""
    return _write_trace_json(
        {"traceEvents": to_chrome_events(records), "displayTimeUnit": "ms"},
        path)


def merge_with_profile(records, profile_path: str, out_path: str) -> str:
    """Merge ``trace`` records onto a ``--profile`` Chrome trace.

    Reads the trace-event JSON(.gz) ``torch.profiler`` wrote (find it with
    :func:`repro_torch.obs.find_perfetto_trace`), offsets our run-relative
    events to the profile's earliest timestamp, appends them under their
    own pid, and writes ``out_path`` — one timeline with device phases and
    host-side request/round churn.
    """
    base = _read_trace_json(profile_path)
    evs = base.get("traceEvents", [])
    t0 = min((float(e["ts"]) for e in evs if "ts" in e), default=0.0)
    base["traceEvents"] = evs + to_chrome_events(records, t0_us=t0)
    return _write_trace_json(base, out_path)
