"""Schema of the streaming telemetry JSONL (``repro_torch.obs``), versioned.

The port's own copy of ``repro.obs.schema``: the same ``SCHEMA_VERSION``,
the same required and optional fields, the same validator and CLI, so a
stream either package writes gets the same verdict from both.

Every line a :class:`repro_torch.obs.MetricsSink` writes is one JSON object
with three envelope fields — ``v`` (schema version), ``kind`` (record type)
and ``step`` (optimizer step the record describes) — plus kind-specific
payload fields.  The kinds:

``train``
    One record per optimizer step, packed on the device by the train step
    (``build_train_step(..., obs=sink)``) and drained host-side in one
    device-to-host copy per read.
    Carries the scalar metrics of the step (``loss_mean``/``loss_worst``/
    ``loss_std``/``robust_objective``, the wire accounting ``comm_bytes``/
    ``wire_bits``/``ef_residual_norm``, optionally ``disagreement``).
    The per-node vectors the paper's trajectories are made of — ``loss_nodes``
    (per-device minibatch loss), ``dr_weights`` (the implied adversarial
    mixture λ*_i, Eq. 4-6 dual) and the on-device ``hist_*`` bin counts
    (:mod:`repro_torch.obs.hist`) — are *decimated*: they ride the tap every
    ``MetricsSink(vector_every=N)``-th step (schema v2; they were required
    on every step in v1).

``eval``
    Host-side record per evaluation: the paper's fairness metrics —
    ``acc_avg``, ``acc_worst_dist`` (worst-distribution accuracy),
    ``acc_node_std`` (per-device accuracy STDEV) — plus the per-node
    accuracy vector ``acc_nodes`` and, when a train tap preceded it, the
    ``dr_weights`` snapshot of the last train step.

``perf``
    One record per ``run_segments`` chunk: the wall-clock phase rollup
    (``phase_s``: seconds per phase), ``steps_per_s`` and
    ``wire_bytes_per_s`` of the chunk.

``meta``
    One free-form record at the head of the stream describing the run
    configuration (arch, nodes, codec, topology, ...).

``serve``
    Periodic engine heartbeat of a :class:`repro_torch.serve.ServeEngine` run
    (``step`` is the decode-step index): batch occupancy (``active_slots``,
    ``queued``) and KV-pool pressure (``kv_occupancy``, worst kind), plus
    throughput/latency rollups (``decode_tok_s``, ``step_ms``) and lifetime
    counters (``admitted``, ``completed``).

``trace``
    One structured span/event record (:mod:`repro_torch.obs.trace`).  ``event``
    names it; everything else is event-specific.  Serve lifecycle events
    (``queued`` → ``admitted`` → ``prefill`` → ``first_token`` →
    ``finished``) are emitted host-side by :class:`repro_torch.serve.ServeEngine`
    with ``rid``/``cls``/``slot``/``pages`` and run-relative timestamps
    ``t_s`` (``step`` is the decode-step index).  Trainer round events
    (``fault``/``ef_rebase``/``rate_switch``) are *derived* host-side from
    the train records plus the seeded fault replay — no extra device
    work in the step.  All are exportable to Chrome/perfetto trace-event JSON.

Extra fields are always allowed (``aux_*`` losses, config keys); the
validator checks the envelope, the kind-required fields, and field types.

Validate a stream from the CLI (CI does)::

    python -m repro_torch.obs.schema runs/telemetry.jsonl
"""

from __future__ import annotations

import json
import math

SCHEMA_VERSION = 2

# type tags: "f" float scalar, "i" int scalar, "s" string,
#            "fv" float vector, "iv" int vector
_ENVELOPE = {"v": "i", "kind": "s", "step": "i"}

#: kind -> {field: type} that MUST be present (beyond the envelope)
REQUIRED_FIELDS: dict[str, dict[str, str]] = {
    "train": {
        "loss_mean": "f",
        "loss_worst": "f",
        "loss_std": "f",
        "robust_objective": "f",
        "comm_bytes": "f",
        "wire_bits": "f",
        "ef_residual_norm": "f",
    },
    "eval": {
        "acc_avg": "f",
        "acc_worst_dist": "f",
        "acc_node_std": "f",
    },
    "perf": {
        "steps_per_s": "f",
        "wall_s": "f",
    },
    "meta": {},
    "serve": {
        "active_slots": "i",
        "queued": "i",
        "kv_occupancy": "f",
    },
    "trace": {
        "event": "s",
    },
}

#: kind -> {field: type} that MAY be present and is type-checked when it is
OPTIONAL_FIELDS: dict[str, dict[str, str]] = {
    "train": {
        "disagreement": "f",
        "scale_mean": "f",
        "scale_max": "f",
        "lambda_max": "f",
        # decimated vector payload (every vector_every-th step, schema v2)
        "loss_nodes": "fv",
        "dr_weights": "fv",
        "hist_loss_nodes": "iv",
        "hist_dr_weights": "iv",
        "hist_ef_res": "iv",
        # EF wire bookkeeping surfaced for host-side event derivation
        "ef_rounds": "i",
        "ef_drift": "f",
    },
    "eval": {
        "acc_node_min": "f",
        "acc_nodes": "fv",
        "dr_weights": "fv",
        "loss_mean": "f",
    },
    "perf": {
        "steps": "i",
        "wire_bytes_per_s": "f",
    },
    "meta": {},
    "serve": {
        "admitted": "i",
        "completed": "i",
        "kv_pages_used": "i",
        "kv_pages_total": "i",
        "decode_tok_s": "f",
        "prefill_tok_s": "f",
        "step_ms": "f",
    },
    "trace": {
        # serve request lifecycle
        "rid": "i",
        "cls": "s",
        "slot": "i",
        "pages": "i",
        "t_s": "f",
        "dur_s": "f",
        "tokens": "i",
        "s0": "i",
        "queued_s": "f",
        "ttft_s": "f",
        "per_token_s": "f",
        # trainer round events (host-derived)
        "round": "i",
        "links_down": "i",
        "nodes_down": "i",
        "down_nodes": "iv",
        "wire_bits_old": "f",
        "wire_bits_new": "f",
        "ef_rounds": "i",
        "ef_drift": "f",
    },
}


def _type_ok(value, tag: str) -> bool:
    if tag == "f":
        return isinstance(value, (int, float)) and not isinstance(value, bool)
    if tag == "i":
        return isinstance(value, int) and not isinstance(value, bool)
    if tag == "s":
        return isinstance(value, str)
    if tag == "fv":
        return isinstance(value, list) and all(
            isinstance(x, (int, float)) and not isinstance(x, bool)
            for x in value)
    if tag == "iv":
        return isinstance(value, list) and all(
            isinstance(x, int) and not isinstance(x, bool) for x in value)
    raise ValueError(f"unknown type tag {tag!r}")


def validate_record(rec) -> list[str]:
    """Return the list of schema violations of one record ([] = valid)."""
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, not an object"]
    errors = []
    for field, tag in _ENVELOPE.items():
        if field not in rec:
            errors.append(f"missing envelope field {field!r}")
        elif not _type_ok(rec[field], tag):
            errors.append(f"envelope field {field!r} has wrong type "
                          f"({type(rec[field]).__name__})")
    if errors:
        return errors
    if rec["v"] > SCHEMA_VERSION:
        errors.append(f"schema version {rec['v']} is newer than this "
                      f"validator ({SCHEMA_VERSION})")
    kind = rec["kind"]
    if kind not in REQUIRED_FIELDS:
        return errors + [f"unknown record kind {kind!r}"]
    for field, tag in REQUIRED_FIELDS[kind].items():
        if field not in rec:
            errors.append(f"{kind} record missing field {field!r}")
        elif not _type_ok(rec[field], tag):
            errors.append(f"{kind} field {field!r} has wrong type")
    for field, tag in OPTIONAL_FIELDS[kind].items():
        if field in rec and not _type_ok(rec[field], tag):
            errors.append(f"{kind} field {field!r} has wrong type")
    return errors


def validate_jsonl(path) -> dict:
    """Validate one JSONL telemetry file.

    Returns a summary dict: ``records`` (total lines), ``kinds`` (count per
    record kind), ``steps`` (train-record step range), ``errors`` (list of
    ``"line N: message"`` strings, empty for a valid stream).
    """
    kinds: dict[str, int] = {}
    errors: list[str] = []
    train_steps: list[int] = []
    n = 0
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            n += 1
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                errors.append(f"line {lineno}: invalid JSON ({e})")
                continue
            for msg in validate_record(rec):
                errors.append(f"line {lineno}: {msg}")
            if isinstance(rec, dict):
                kinds[rec.get("kind", "?")] = kinds.get(rec.get("kind", "?"), 0) + 1
                if rec.get("kind") == "train" and isinstance(rec.get("step"), int):
                    train_steps.append(rec["step"])
    dup = len(train_steps) != len(set(train_steps))
    if dup:
        errors.append("duplicate train-record steps")
    return {
        "records": n,
        "kinds": kinds,
        "steps": ((min(train_steps), max(train_steps)) if train_steps else None),
        "train_steps_contiguous": (
            bool(train_steps)
            and not dup
            and sorted(train_steps)
            == list(range(min(train_steps), max(train_steps) + 1))),
        "errors": errors,
    }


def _finite(rec: dict) -> list[str]:
    """Non-finite float fields of a record (allowed by the schema, but a CI
    smoke run wants to know)."""
    bad = []
    for k, v in rec.items():
        if isinstance(v, float) and not math.isfinite(v):
            bad.append(k)
    return bad


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="validate a repro_torch.obs telemetry JSONL file")
    ap.add_argument("paths", nargs="+")
    ap.add_argument("--require-kinds", default="",
                    help="comma-separated record kinds that must be present "
                         "(e.g. 'train,eval,perf,meta')")
    ap.add_argument("--require-contiguous", action="store_true",
                    help="train records must cover a contiguous step range "
                         "with no duplicates")
    args = ap.parse_args(argv)
    rc = 0
    for path in args.paths:
        summary = validate_jsonl(path)
        print(f"{path}: {summary['records']} records {summary['kinds']} "
              f"steps={summary['steps']}")
        for err in summary["errors"]:
            print(f"  ERROR {err}")
            rc = 1
        for kind in filter(None, args.require_kinds.split(",")):
            if kind not in summary["kinds"]:
                print(f"  ERROR no {kind!r} records in stream")
                rc = 1
        if args.require_contiguous and not summary["train_steps_contiguous"]:
            print("  ERROR train steps not contiguous/unique")
            rc = 1
    print("schema OK" if rc == 0 else "schema INVALID")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
