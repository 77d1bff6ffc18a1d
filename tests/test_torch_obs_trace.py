"""The port's trace events (``repro_torch.obs.trace``) against the
reference's ``repro.obs.trace``.

The fault coins are the port's own (Philox streams, the same bits on every
device, not the reference's), so the fault events are held
on the reference's replayed masks, injected through the port's one seam
``comm/topology.py::round_fault_masks``, which the port's replay goes
through.  The EF re-base and rate-switch derivations and the Chrome export
are held on shared records; the replay runs on the device the run's meta
record names and raises where that device is absent.
"""

import gzip
import json

import numpy as np
import pytest
import torch

from repro.dynamics import FaultConfig as RefFaultConfig
from repro.dynamics import replay_fault_masks as ref_replay_fault_masks
from repro.obs import trace as ref_trace
from repro.obs.report import summarize_run as ref_summarize_run
from repro_torch.comm import topology as comm_topology
from repro_torch.dynamics import FaultConfig
from repro_torch.obs import MetricsSink, find_perfetto_trace, profile, validate_jsonl
from repro_torch.obs import trace as port_trace
from repro_torch.obs.report import summarize_run
from repro_torch.obs.schema import SCHEMA_VERSION

K, STEPS = 6, 24


def _train_rec(step, **extra):
    rec = {"v": SCHEMA_VERSION, "kind": "train", "step": step, "loss_mean": 1.0,
           "loss_worst": 1.5, "loss_std": 0.1, "robust_objective": 1.1, "comm_bytes": 8.0,
           "wire_bits": 64.0, "ef_residual_norm": 0.0}
    rec.update(extra)
    return rec


def _inject(monkeypatch, ref_cfg, k, rounds):
    keep, up = (np.array(a) for a in ref_replay_fault_masks(ref_cfg, np.arange(rounds), k))
    seen = []

    def masks(faults, r, kk, device):
        assert kk == k
        seen.append((r, torch.device(device).type))
        return torch.from_numpy(keep[r]).to(device), torch.from_numpy(up[r]).to(device)

    monkeypatch.setattr(comm_topology, "round_fault_masks", masks)
    return seen


@pytest.mark.parametrize("kw", [dict(straggler_p=0.4, seed=7),
                                dict(straggler_p=0.3, outage_p=0.2, outage_len=3, seed=2),
                                dict(link_drop_p=0.2, straggler_p=0.2, seed=5)],
                         ids=["stragglers", "outages", "links"])
def test_fault_events_equal_the_reference_on_its_masks(monkeypatch, kw):
    recs = [_train_rec(s) for s in range(STEPS)]
    seen = _inject(monkeypatch, RefFaultConfig(**kw), K, STEPS)
    got = port_trace.trainer_trace_events(recs, faults=FaultConfig(**kw), num_nodes=K,
                                          device="cpu")
    want = ref_trace.trainer_trace_events(recs, faults=RefFaultConfig(**kw), num_nodes=K)
    assert got == want and any(e["event"] == "fault" for e in got)
    assert seen == [(s, "cpu") for s in range(STEPS)]


def test_fault_replay_infers_num_nodes_and_needs_the_run_device():
    cfg = FaultConfig(straggler_p=0.5, seed=1)
    with_vec = [_train_rec(0, loss_nodes=[1.0] * 5), _train_rec(1)]
    events = port_trace.trainer_trace_events(with_vec, faults=cfg, device="cpu")
    assert all(e["event"] == "fault" and max(e["down_nodes"], default=0) < 5 for e in events)
    with pytest.raises(ValueError, match="num_nodes"):
        port_trace.trainer_trace_events([_train_rec(0)], faults=cfg, device="cpu")
    if not torch.cuda.is_available():  # a replay asked on a card that is not there raises
        with pytest.raises(RuntimeError, match="CUDA"):
            port_trace.trainer_trace_events(with_vec, faults=cfg, device="cuda")
        meta = {"v": SCHEMA_VERSION, "kind": "meta", "step": 0, "nodes": 5,
                "straggler_p": 0.5, "seed": 1, "device": "cuda"}
        assert "CUDA" in summarize_run([meta] + with_vec)["events_error"]


def test_ef_rebase_and_rate_switch_equal_the_reference():
    recs = [_train_rec(s, ef_rounds=s + 1, ef_drift=0.1 * s,
                       wire_bits=64.0 if s < 9 else 32.0) for s in range(16)]
    for kw in (dict(ef_rebase_every=4), dict(ef_rebase_threshold=0.55),
               dict(topology="dropout"), dict()):
        got = port_trace.trainer_trace_events(recs, **kw)
        assert got == ref_trace.trainer_trace_events(recs, **kw), kw
    assert {e["event"] for e in port_trace.trainer_trace_events(recs, ef_rebase_every=4)} \
        == {"ef_rebase", "rate_switch"}


def _serve_and_train():
    serve = [
        {"v": SCHEMA_VERSION, "kind": "trace", "step": 0, "event": "queued", "rid": 0,
         "cls": "chat", "t_s": 0.0},
        {"v": SCHEMA_VERSION, "kind": "trace", "step": 0, "event": "admitted", "rid": 0,
         "cls": "chat", "slot": 1, "pages": 2, "t_s": 0.01},
        {"v": SCHEMA_VERSION, "kind": "trace", "step": 5, "event": "finished", "rid": 0,
         "cls": "chat", "slot": 1, "tokens": 4, "t_s": 0.5, "dur_s": 0.49, "ttft_s": 0.2,
         "per_token_s": 0.05, "queued_s": 0.01},
    ]
    train = port_trace.trainer_trace_events(
        [_train_rec(s, ef_rounds=s + 1) for s in range(4)], ef_rebase_every=2)
    return serve + train


@pytest.mark.parametrize("suffix", [".json", ".json.gz"])
def test_chrome_export_equals_the_reference(tmp_path, suffix):
    recs = _serve_and_train()
    for t0 in (0.0, 5e6):
        assert port_trace.to_chrome_events(recs, t0_us=t0, pid="p") == \
            ref_trace.to_chrome_events(recs, t0_us=t0, pid="p")
    got, want = tmp_path / f"port{suffix}", tmp_path / f"ref{suffix}"
    port_trace.export_chrome_trace(recs, str(got))
    ref_trace.export_chrome_trace(recs, str(want))
    opener = gzip.open if suffix.endswith(".gz") else open
    with opener(got, "rt") as f, opener(want, "rt") as g:
        a, b = json.load(f), json.load(g)
    for e in a["traceEvents"] + b["traceEvents"]:
        e.pop("pid")
    assert a == b


def test_merge_onto_a_torch_profile(tmp_path):
    with profile(str(tmp_path)) as prof:
        torch.ones(4).sum()
    assert prof.trace_path == find_perfetto_trace(str(tmp_path))
    with open(prof.trace_path) as f:
        base = json.load(f)["traceEvents"]
    t0 = min(float(e["ts"]) for e in base if "ts" in e)
    recs = _serve_and_train()
    out = str(tmp_path / "merged.json")
    port_trace.merge_with_profile(recs, prof.trace_path, out)
    with open(out) as f:
        merged = json.load(f)["traceEvents"]
    assert merged[:len(base)] == base
    ours = merged[len(base):]
    assert len(ours) == len(port_trace.to_chrome_events(recs))
    assert next(e for e in ours if e["name"] == "queued")["ts"] == pytest.approx(t0)


def test_fault_events_through_the_sink_and_the_report(monkeypatch, tmp_path):
    """A faulted run's stream: the report's replay (on the meta's device)
    names the reference's fault rounds, and the reference's own report of
    the same stream (its own coins) still validates the events' schema."""
    kw = dict(straggler_p=0.4, seed=3)
    _inject(monkeypatch, RefFaultConfig(**kw), K, STEPS)
    with MetricsSink(str(tmp_path)) as sink:
        sink.log("meta", 0, nodes=K, straggler_p=0.4, seed=3, device="cpu")
        for s in range(STEPS):
            sink.log("train", s, **{k: v for k, v in _train_rec(s).items()
                                    if k not in ("v", "kind", "step")})
    recs = [json.loads(line) for line in open(sink.path)]
    events = [e for e in summarize_run(recs)["trace_records"] if e["event"] == "fault"]
    want = ref_trace.trainer_trace_events(recs, faults=RefFaultConfig(**kw), num_nodes=K)
    assert events == want
    assert validate_jsonl(sink.path)["errors"] == []
    assert "events" in ref_summarize_run(recs)
