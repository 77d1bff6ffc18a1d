"""Streaming metrics sink: device-side taps → host ring buffer → typed JSONL.

The port of ``repro.obs.sink``.  The sink is the host-side record of a
training run.  Three ways in:

* :meth:`MetricsSink.tap_pack` / :meth:`MetricsSink.tap_drain` — the
  batched tap ``build_train_step`` stages when the trainer is built with
  ``obs=sink``.  ``tap_pack`` wraps the step's record (the metrics the step
  already computed, as device tensors: no synchronisation);
  ``trainer.step``/``trainer.run`` pop it from the metrics with
  ``tap_drain`` and queue it, so the metrics callers see are the same with
  the sink on or off.  The queued records reach the host as ONE flat
  float32 payload in ONE device-to-host copy when the stream is next read
  (:meth:`barrier`, which :meth:`records`, :meth:`last`, :meth:`log`,
  :meth:`flush` and :meth:`close` call), one record per step in step
  order.  Vector fields (per-node losses, DR weights, histogram counts) are
  *decimated*: the step packs them only where :meth:`wants_vectors` says so,
  every :attr:`vector_every`-th step, decided from the host's own step
  index.  An ordinary step launches nothing: the layout of a record (its
  fields' names, shapes and kinds) is worked out once per shape of record
  and cached, and the tap keeps the step's 0-d metrics as they are (fresh
  tensors that nothing updates in place) until the drain stacks every
  queued record's in one ``torch.stack``.  Histograms are bucketed when the
  sink drains, on the host, from the values the step handed over
  (``hists``; a ``log10`` grid's transform is computed in the step with the
  ops :func:`~repro_torch.obs.hist.hist_counts` uses, so the bins are
  those the on-device count gives).

* :meth:`MetricsSink.tap` — the live variant: the same pack, drained at
  once (one synchronisation per call), for loops that must see each step's
  record as it lands.

* :meth:`MetricsSink.log` — plain host-side records (``eval``/``perf``/
  ``meta``/``trace``) written into the same stream, after any queued taps,
  so the paper's fairness metrics, the phase-timer rollups and the serve
  engine's request lifecycle interleave with the per-step trajectory.

Records land in a bounded ring buffer (:meth:`records`) and, when
``log_dir`` is given, in ``<log_dir>/<name>.jsonl`` — one schema-versioned
JSON object per line (:mod:`repro_torch.obs.schema`).  Console output is a
*formatter over the same record* (:func:`format_record`), so the printed
line cannot drift from the JSONL fields.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.obs.hist import bucket_counts, transform
from repro_torch.obs.schema import SCHEMA_VERSION, validate_record


def _to_py(v) -> Any:
    """One telemetry value → JSON-encodable python (floats / int / list)."""
    if isinstance(v, (str, bool, int, float)) or v is None:
        return v
    if isinstance(v, dict):
        return {k: _to_py(x) for k, x in v.items()}
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    arr = np.asarray(v)
    cast = int if np.issubdtype(arr.dtype, np.integer) else float
    if arr.ndim == 0:
        return cast(arr)
    return [cast(x) for x in arr.reshape(-1)]


class _Layout(NamedTuple):
    """How one shape of record queues and decodes: which fields are 0-d
    tensors, which are other tensors and which host values, and the
    record's fields in name order, each with where its value lands."""

    scalars: tuple              # indices of the 0-d tensor fields
    vectors: tuple              # indices of the other tensor fields
    host: tuple                 # indices of the host fields
    n_vec: int                  # floats of the vectors and histogram inputs
    fields: tuple               # sorted ((name, where, offset, size, is_int,
                                # HistSpec or None), ...); where: 0 the
                                # scalars, 1 the vectors, 2 the host values


class _Tap(NamedTuple):
    """One step's record as queued: its 0-d tensors and its other tensors
    (vectors, histogram inputs) on the step's device, its layout, and the
    fields that were host values already."""

    kind: str
    step: int
    scalars: list               # 0-d tensors, stacked at the drain
    vectors: list               # the other tensors, flattened at the drain
    layout: _Layout
    host: dict


class MetricsSink:
    """Host-side telemetry stream of one run (ring buffer + optional JSONL).

    Args:
      log_dir: directory for the JSONL file (created if missing); None keeps
        records only in the in-memory ring buffer.
      name: stem of the JSONL file (``<name>.jsonl``).
      ring: ring-buffer capacity (oldest records drop first; the JSONL file
        always keeps everything).  At most this many taps are queued before
        they are drained.
      vector_every: cadence of the decimated vector payload — vectors land
        only on records whose step is a multiple of this (1 = every step).
        Scalars always land every step.
    """

    def __init__(self, log_dir: str | None = None, *, name: str = "telemetry",
                 ring: int = 4096, vector_every: int = 8):
        if vector_every < 1:
            raise ValueError("vector_every must be >= 1")
        self._ring: collections.deque = collections.deque(maxlen=ring)
        self._pending: list[_Tap] = []
        self._layouts: dict = {}
        self.vector_every = int(vector_every)
        self.path = None
        self._file = None
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            self.path = os.path.join(log_dir, f"{name}.jsonl")
            self._file = open(self.path, "a", buffering=1)

    # -- the tap ----------------------------------------------------------------

    def wants_vectors(self, step: int) -> bool:
        """Whether step ``step``'s record carries the vector payload."""
        return step % self.vector_every == 0

    def _layout(self, names: tuple, vals: list, hists: tuple) -> _Layout:
        """The layout of a record with these fields (cached by their names,
        tensor shapes and the histogram specs)."""
        shapes = tuple(v.shape if isinstance(v, torch.Tensor) else None for v in vals)
        key = (names, shapes, hists)
        lay = self._layouts.get(key)
        if lay is None:
            def is_int(i):
                return not (vals[i].is_floating_point() or vals[i].is_complex())

            scalars = tuple(i for i, sh in enumerate(shapes) if sh is not None and len(sh) == 0)
            vectors = tuple(i for i, sh in enumerate(shapes) if sh is not None and len(sh))
            host = tuple(i for i, sh in enumerate(shapes) if sh is None)
            fields = [(names[i], 0, j, 1, is_int(i), None) for j, i in enumerate(scalars)]
            fields += [(names[i], 2, 0, 0, False, None) for i in host]
            off = 0
            for name, n, integral, spec in ([(names[i], vals[i].numel(), is_int(i), None)
                                             for i in vectors]
                                            + [(spec.field, n, False, spec) for spec, n in hists]):
                fields.append((name, 1, off, n, integral, spec))
                off += n
            lay = _Layout(scalars, vectors, host, off, tuple(sorted(fields)))
            self._layouts[key] = lay
        return lay

    def _pack(self, kind: str, step: int, fields: dict, hists: dict | None = None) -> _Tap:
        """Queue a record's device tensors as they are, to be moved to the
        host as one flat float32 payload at the drain (ints round-trip
        exactly below 2**24: bin counts); host numbers ride beside it.
        ``hists`` maps a :class:`~repro_torch.obs.hist.HistSpec` to the
        tensor it buckets: its transformed values are queued and bucketed
        at the drain."""
        names, vals = tuple(fields), list(fields.values())
        hist_vals = []
        if hists:
            with torch.no_grad():
                hist_vals = [transform(spec, x) for spec, x in hists.items()]
        lay = self._layout(names, vals, tuple((spec, x.numel()) for spec, x in
                                              zip(hists or {}, hist_vals)))
        return _Tap(kind, int(step), [vals[i] for i in lay.scalars],
                    [vals[i] for i in lay.vectors] + hist_vals, lay,
                    {names[i]: vals[i] for i in lay.host})

    def tap_pack(self, step: int, fields: dict, kind: str = "train", *,
                 vectors: dict | None = None, hists: dict | None = None) -> dict:
        """This step's record for the stream: ``{"_tap": <record>}`` for the
        train step to merge into the metrics it returns.  The record keeps
        the tensors it is given until the drain reads them: they must not
        be updated in place meanwhile (the step's metrics are fresh
        tensors).  Pass ``vectors`` and ``hists`` (HistSpec → the tensor it
        buckets, whose counts land as ``spec.field``) only where
        :meth:`wants_vectors` holds."""
        if vectors:
            fields = {**fields, **vectors}
        return {"_tap": self._pack(kind, step, fields, hists)}

    def tap_drain(self, metrics: dict) -> dict:
        """Pop the ``_tap`` entry :meth:`tap_pack` added and queue it; returns
        ``metrics`` without it, so callers never see it."""
        if "_tap" not in metrics:
            return metrics
        metrics = dict(metrics)
        self._pending.append(metrics.pop("_tap"))
        if len(self._pending) >= self._ring.maxlen:
            self.barrier()
        return metrics

    def tap(self, step: int, fields: dict, kind: str = "train", *,
            vectors: dict | None = None, vector_every: int | None = None) -> None:
        """Deliver one record now (one synchronisation): ``fields`` every
        call, ``vectors`` on steps that are a multiple of ``vector_every``
        (default: the sink's :attr:`vector_every`)."""
        every = self.vector_every if vector_every is None else max(1, int(vector_every))
        if vectors and step % every == 0:
            fields = {**fields, **vectors}
        self._pending.append(self._pack(kind, step, fields))
        self.barrier()

    # -- host-side records ------------------------------------------------------

    def log(self, kind: str, step: int, **fields) -> dict:
        """Append a host-side record (eval / perf / meta / trace) to the
        stream, after the taps queued before it."""
        self.barrier()
        rec = self._make_record(kind, int(step), {k: _to_py(v) for k, v in fields.items()
                                                  if v is not None})
        self._push(rec)
        return rec

    @staticmethod
    def _make_record(kind: str, step: int, fields: dict) -> dict:
        rec = {"v": SCHEMA_VERSION, "kind": kind, "step": step}
        rec.update(fields)
        return rec

    def _push(self, rec: dict) -> None:
        self._ring.append(rec)
        if self._file is not None:
            self._file.write(json.dumps(rec) + "\n")

    # -- reading back -----------------------------------------------------------

    def barrier(self) -> None:
        """Move every queued tap to the host in one device-to-host copy (one
        ``torch.stack`` of their 0-d tensors and one ``cat`` with the rest)
        and push its records in step order (nothing to do, no
        synchronisation, when none is queued)."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        with torch.no_grad():
            scalars = [x for t in pending for x in t.scalars]
            parts = ([torch.stack(scalars)] if scalars else []) + [
                x.reshape(-1) for t in pending for x in t.vectors]
            flat = (torch.cat(parts).float().cpu().numpy() if parts
                    else np.zeros(0, np.float32))
        # the scalars, then every vector in queue order; a record's fields
        # in name order, as _make_record over sorted fields gives them
        scal, vecs = flat[:len(scalars)].tolist(), flat[len(scalars):]
        soff = voff = 0
        for t in pending:
            rec = {"v": SCHEMA_VERSION, "kind": t.kind, "step": t.step}
            for name, where, off, size, is_int, spec in t.layout.fields:
                if where == 0:
                    x = scal[soff + off]
                    rec[name] = int(x) if is_int else x
                elif where == 2:
                    rec[name] = t.host[name]
                else:
                    chunk = vecs[voff + off:voff + off + size]
                    if spec is not None:
                        rec[name] = bucket_counts(chunk, spec)
                    else:
                        vals = chunk.tolist()
                        if is_int:
                            vals = [int(x) for x in vals]
                        rec[name] = vals[0] if size == 1 else vals
            soff += len(t.scalars)
            voff += t.layout.n_vec
            self._push(rec)

    def records(self, kind: str | None = None) -> list[dict]:
        self.barrier()
        recs = list(self._ring)
        if kind is None:
            return recs
        return [r for r in recs if r["kind"] == kind]

    def last(self, kind: str | None = None) -> dict | None:
        self.barrier()
        for rec in reversed(self._ring):
            if kind is None or rec["kind"] == kind:
                return rec
        return None

    def last_with(self, kind: str | None, field: str) -> dict | None:
        """Newest record of ``kind`` that carries ``field`` — the lookup for
        decimated vector fields (``dr_weights`` etc.), which only land every
        :attr:`vector_every`-th train record."""
        self.barrier()
        for rec in reversed(self._ring):
            if (kind is None or rec["kind"] == kind) and field in rec:
                return rec
        return None

    # -- lifecycle --------------------------------------------------------------

    def flush(self) -> None:
        self.barrier()
        if self._file is not None:
            self._file.flush()

    def close(self) -> None:
        self.flush()
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self) -> "MetricsSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def validate(self) -> list[str]:
        """Schema-check every record currently in the ring buffer."""
        errors = []
        for i, rec in enumerate(self.records()):
            for msg in validate_record(rec):
                errors.append(f"record {i}: {msg}")
        return errors


# -- console formatters (the print line IS the record) -------------------------

def format_train(rec: dict, compressed: bool = False) -> str:
    line = (f"step {rec['step']:5d} loss_mean={rec['loss_mean']:.4f} "
            f"loss_worst={rec['loss_worst']:.4f} "
            f"disagree={rec.get('disagreement', 0.0):.2e} "
            f"comm_bytes={rec.get('comm_bytes', 0.0):.3e}")
    if compressed:
        line += (f" ef_res={rec.get('ef_residual_norm', 0.0):.2e}"
                 f" wire_bits={rec.get('wire_bits', 0.0):.3e}")
    return line


def format_eval(rec: dict) -> str:
    line = f"step {rec['step']:5d}"
    if "loss_mean" in rec:
        line += f" loss={rec['loss_mean']:.4f}"
    line += (f" acc_avg={rec['acc_avg']:.3f} "
             f"acc_worst={rec['acc_worst_dist']:.3f} "
             f"std={rec['acc_node_std']:.3f}")
    if "comm_bytes" in rec:
        line += f" comm_bytes={rec['comm_bytes']:.3e}"
    return line


def format_perf(rec: dict) -> str:
    phases = rec.get("phase_s", {})
    ph = " ".join(f"{k}={v:.2f}s" for k, v in phases.items()) if phases else ""
    line = f"perf step {rec['step']:5d} steps/s={rec['steps_per_s']:.1f}"
    if "wire_bytes_per_s" in rec:
        line += f" wire_bytes/s={rec['wire_bytes_per_s']:.3e}"
    return line + (f" [{ph}]" if ph else "")


def format_meta(rec: dict) -> str:
    skip = {"v", "kind", "step"}
    return " ".join(f"{k}={rec[k]}" for k in rec if k not in skip)


def format_serve(rec: dict) -> str:
    line = (f"serve step {rec['step']:6d} active={rec['active_slots']:3d} "
            f"queued={rec['queued']:3d} kv_occ={rec['kv_occupancy']:.2f}")
    if "decode_tok_s" in rec:
        line += f" decode_tok/s={rec['decode_tok_s']:.1f}"
    if "step_ms" in rec:
        line += f" step={rec['step_ms']:.2f}ms"
    if "completed" in rec:
        line += f" done={rec['completed']}/{rec.get('admitted', 0)}"
    return line


def format_trace(rec: dict) -> str:
    skip = {"v", "kind", "step", "event"}
    rest = " ".join(
        f"{k}={rec[k]:.4f}" if isinstance(rec[k], float) else f"{k}={rec[k]}"
        for k in rec if k not in skip)
    return f"trace step {rec['step']:6d} {rec['event']:<12s} {rest}"


def format_record(rec: dict, **kw) -> str:
    """Render one telemetry record as the console line for its kind."""
    fmt = {"train": format_train, "eval": format_eval, "perf": format_perf,
           "meta": format_meta, "serve": format_serve,
           "trace": format_trace}.get(rec.get("kind"))
    if fmt is None:
        return json.dumps(rec)
    return fmt(rec, **kw) if rec.get("kind") == "train" else fmt(rec)
