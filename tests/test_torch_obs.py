"""The port's telemetry (``repro_torch.obs``: schema, histograms, the sink,
the profiler scopes) against the reference's ``repro.obs``.

* The schema is the port's own copy: both validators give the same verdict
  on every record of the reference's fixture and on a set of bad records.
* ``edges`` equal the reference's float32 edges bit for bit on every
  ``TRAIN_HISTOGRAMS`` spec, and ``hist_counts`` give the reference's counts
  at the edges, out of range and on log10 data.  XLA's and PyTorch's
  ``log10`` may round an ulp apart, so the log10 data is checked to hold no
  value within 2 ulps of an edge (as the MoE routing tests check for ties).
* The sink changes no bit: the metrics and the trajectory of a run with the
  sink and the sanitizer equal those of the run without them.
* The tap's ops, counted under a ``TorchDispatchMode`` on the CPU, stay at
  the queued design's: none on an ordinary step; ef_res's clamp and log10
  and three views on a vector step (the sink stacks the queued records and
  buckets the histograms when it drains, and ``bucket_counts`` gives
  ``hist_counts``'s counts).
* A 20-step fmnist run (K = 8, ring, Metropolis W) streams train records
  equal to the reference's: scalars at the trainer tests' trajectory
  tolerance (rtol 1e-5, atol 1e-6), vectors on the same decimated steps,
  histogram counts equal (the data is checked to keep every per-node loss
  and DR weight more than 1e-4 from a bin edge), and the port's JSONL
  passes the reference's validator.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import DecentralizedTrainer as RefTrainer
from repro.core import RobustConfig as RefRobust
from repro.data import make_fmnist_like as ref_make_fmnist_like
from repro.data import pathological_noniid_partition as ref_partition
from repro.models import paper_nets as ref_nets
from repro.obs import MetricsSink as RefSink
from repro.obs import hist as ref_hist
from repro.obs import schema as ref_schema
from repro_torch import convert
from repro_torch.core import DecentralizedTrainer, RobustConfig, TrainerSpec, drdsgd, run_segments
from repro_torch.data import make_fmnist_like, pathological_noniid_partition
from repro_torch.models import paper_nets as nets
from repro_torch.obs import (
    TRAIN_HISTOGRAMS,
    MetricsSink,
    PhaseTimer,
    format_record,
    hist_counts,
    scope,
    validate_jsonl,
    validate_record,
)
from repro_torch.obs import hist as port_hist
from repro_torch.obs.schema import SCHEMA_VERSION

K, B, STEPS, SEED = 8, 32, 20, 0
LR = (K / 300) ** 0.5
TRAJ = dict(rtol=1e-5, atol=1e-6)
EDGE_GAP = 1e-4     # smallest distance of a bucketed value from a bin edge
FIXTURE = "tests/data/mini_log/telemetry.jsonl"


# -- schema ---------------------------------------------------------------------

def _bad_records():
    good = {"v": SCHEMA_VERSION, "kind": "train", "step": 3, "loss_mean": 1.0,
            "loss_worst": 2.0, "loss_std": 0.1, "robust_objective": 1.1, "comm_bytes": 0.0,
            "wire_bits": 0.0, "ef_residual_norm": 0.0}
    return [
        good,
        {**good, "v": SCHEMA_VERSION + 1},
        {k: v for k, v in good.items() if k != "loss_worst"},
        {**good, "loss_mean": "1.0"},
        {**good, "step": 1.5},
        {**good, "loss_nodes": [1.0, True]},
        {**good, "hist_ef_res": [1, 2.0]},
        {**good, "ef_rounds": 2.0},
        {**good, "kind": "nope"},
        {"v": SCHEMA_VERSION, "kind": "eval", "step": 0, "acc_avg": 0.5,
         "acc_worst_dist": 0.1},
        {"v": SCHEMA_VERSION, "kind": "serve", "step": 0, "active_slots": 1, "queued": 0,
         "kv_occupancy": 1},
        {"v": SCHEMA_VERSION, "kind": "trace", "step": 0, "event": "fault",
         "down_nodes": [0.5]},
        {"v": SCHEMA_VERSION, "kind": "meta", "step": 0, "anything": [1, "a"]},
        {"kind": "train", "step": 0},
        [1, 2],
    ]


def test_schema_verdicts_equal_the_reference():
    with open(FIXTURE) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    for rec in recs + _bad_records():
        assert validate_record(rec) == ref_schema.validate_record(rec), rec
    assert ref_schema.REQUIRED_FIELDS == __import__(
        "repro_torch.obs.schema", fromlist=["x"]).REQUIRED_FIELDS
    assert validate_jsonl(FIXTURE) == ref_schema.validate_jsonl(FIXTURE)


# -- histograms -----------------------------------------------------------------

@pytest.mark.parametrize("spec", TRAIN_HISTOGRAMS, ids=[s.source for s in TRAIN_HISTOGRAMS])
def test_edges_equal_the_reference_bitwise(spec):
    ref_spec = ref_hist.HistSpec(spec.source, spec.lo, spec.hi, spec.bins, spec.log10)
    want = np.asarray(ref_hist.edges(ref_spec))
    got = port_hist.edges(spec).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _hist_data(spec, rng):
    """Values at every edge, past both ends, and spread inside the range."""
    e = port_hist.edges(spec).numpy().astype(np.float64)
    if spec.log10:
        # the log10 grid: values whose log10 lands away from the edges, plus
        # the clamp (0 → log10(1e-30)) and the range's ends out of range
        inner = 10.0 ** rng.uniform(spec.lo, spec.hi, 64)
        return np.concatenate([inner, [0.0, 1e-12, 10.0 ** (spec.hi + 1)]]).astype(np.float32)
    inner = rng.uniform(spec.lo, spec.hi, 64)
    outside = [spec.lo - 1.0, spec.hi + 1.0, np.nextafter(np.float32(spec.hi), np.inf)]
    return np.concatenate([e, inner, outside]).astype(np.float32)


@pytest.mark.parametrize("spec", TRAIN_HISTOGRAMS, ids=[s.source for s in TRAIN_HISTOGRAMS])
def test_hist_counts_equal_the_reference(spec):
    ref_spec = ref_hist.HistSpec(spec.source, spec.lo, spec.hi, spec.bins, spec.log10)
    x = _hist_data(spec, np.random.default_rng(1))
    if spec.log10:
        # no bucketed value within 2 ulps of an edge (log10 may round apart)
        t = np.log10(np.maximum(x.astype(np.float64), 1e-30))
        e = port_hist.edges(spec).numpy().astype(np.float64)
        gap = np.abs(t[:, None] - e[None, :]).min()
        assert gap > 2 * np.spacing(np.float32(max(abs(spec.lo), abs(spec.hi)))), gap
    got = hist_counts(torch.from_numpy(x), spec)
    want = np.asarray(ref_hist.hist_counts(jnp.asarray(x), ref_spec))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) < x.size  # the out-of-range values are dropped


@pytest.mark.parametrize("spec", TRAIN_HISTOGRAMS, ids=lambda s: s.source)
def test_drain_buckets_equal_the_device_counts(spec):
    """The sink's drain-time bucketing (``bucket_counts`` on the
    transformed float32 values) against ``hist_counts``: every edge, one
    float32 ulp either side of it, out of range, NaN and infinities."""
    e = port_hist.edges(spec).numpy()
    near = np.concatenate([e, np.nextafter(e, np.float32(-np.inf)),
                           np.nextafter(e, np.float32(np.inf)),
                           [e[0] - 1, e[-1] + 1, np.nan, np.inf, -np.inf]]).astype(np.float32)
    x = np.float32(10.0) ** near if spec.log10 else near
    want = hist_counts(torch.from_numpy(x), spec).tolist()
    got = port_hist.bucket_counts(port_hist.transform(spec, torch.from_numpy(x)).numpy(), spec)
    assert got == want and sum(want) > spec.bins


def test_hist_spec_validates_its_grid():
    with pytest.raises(ValueError, match="bins"):
        port_hist.HistSpec("x", 0.0, 1.0, bins=0)
    with pytest.raises(ValueError, match="hi > lo"):
        port_hist.HistSpec("x", 1.0, 1.0)


# -- the sink -------------------------------------------------------------------

def test_sink_queues_taps_and_drains_them_in_one_read(tmp_path):
    sink = MetricsSink(str(tmp_path), vector_every=2)
    for step in range(4):
        vec = {"loss_nodes": torch.tensor([1.0, 2.0]), "hist_x": torch.tensor([3, 4])} \
            if sink.wants_vectors(step) else None
        metrics = {"loss_mean": torch.tensor(float(step)), "x": torch.tensor(1.0)}
        metrics.update(sink.tap_pack(step, {"loss_mean": metrics["loss_mean"],
                                            "ef_rounds": step + 1}, vectors=vec))
        assert sink.tap_drain(metrics).keys() == {"loss_mean", "x"}
    assert len(sink._pending) == 4 and list(sink._ring) == []
    recs = sink.records("train")
    assert [r["step"] for r in recs] == [0, 1, 2, 3] and not sink._pending
    assert recs[0] == {"v": SCHEMA_VERSION, "kind": "train", "step": 0, "ef_rounds": 1,
                       "hist_x": [3, 4], "loss_mean": 0.0, "loss_nodes": [1.0, 2.0]}
    assert "loss_nodes" not in recs[1] and recs[2]["hist_x"] == [3, 4]
    assert sink.last_with("train", "loss_nodes")["step"] == 2
    sink.log("eval", 3, acc_avg=0.5, acc_worst_dist=0.25, acc_node_std=0.1, skip=None)
    sink.tap(4, {"loss_mean": torch.tensor(2.5)}, vectors={"loss_nodes": torch.ones(2)})
    assert sink.last("train")["loss_nodes"] == [1.0, 1.0]
    sink.close()
    with open(sink.path) as f:
        kinds = [json.loads(line)["kind"] for line in f]
    assert kinds == ["train"] * 4 + ["eval", "train"]
    assert "skip" not in sink.records("eval")[0]


def test_sink_ring_bounds_memory_and_drains_a_full_queue():
    sink = MetricsSink(ring=4)
    for step in range(10):
        sink.tap_drain(sink.tap_pack(step, {"a": torch.tensor(1.0)}))
        assert len(sink._pending) < 4
    assert [r["step"] for r in sink.records()] == [6, 7, 8, 9]


def test_formatters_render_the_record_fields():
    rec = {"v": 2, "kind": "train", "step": 7, "loss_mean": 1.25, "loss_worst": 2.5,
           "comm_bytes": 10.0, "ef_residual_norm": 0.5, "wire_bits": 80.0}
    assert format_record(rec).startswith("step     7 loss_mean=1.2500 loss_worst=2.5000")
    assert "wire_bits=8.000e+01" in format_record(rec, compressed=True)
    perf = {"v": 2, "kind": "perf", "step": 9, "steps_per_s": 12.5, "wall_s": 1.0,
            "phase_s": {"run": 0.8}}
    assert format_record(perf) == "perf step     9 steps/s=12.5 [run=0.80s]"


def test_scopes_are_no_ops_without_a_profiler():
    assert isinstance(scope("obs:x"), type(__import__("contextlib").nullcontext()))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with scope("obs:x"):
            torch.ones(2).sum()
    assert "obs:x" in {e.key for e in prof.key_averages()}
    timer = PhaseTimer()
    with timer.phase("run"):
        pass
    rec = timer.rollup(steps=4, wire_bytes=8.0)
    assert set(rec) == {"wall_s", "steps", "steps_per_s", "phase_s", "wire_bytes_per_s"}


# -- the train step's tap against the reference's ---------------------------------

@pytest.fixture(scope="module")
def fmnist():
    fed_ref = ref_partition(ref_make_fmnist_like(n_train=2000, n_test=200), K, seed=SEED)
    fed = pathological_noniid_partition(make_fmnist_like(n_train=2000, n_test=200), K,
                                        seed=SEED)
    rng_ref, rng = np.random.default_rng(SEED), np.random.default_rng(SEED)
    batches = [fed.sample_batch(rng, B) for _ in range(STEPS)]
    for (xa, ya), (xb, yb) in zip((fed_ref.sample_batch(rng_ref, B) for _ in range(STEPS)),
                                  batches):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
    params = jax.tree.map(np.asarray, ref_nets.mlp_init(jax.random.PRNGKey(SEED)))
    return dict(fed=fed, batches=batches, params=params)


def _port_run(fmnist, obs=None, sanitize=False):
    trainer = DecentralizedTrainer(nets.make_classifier_loss(nets.mlp_apply), nets.mlp_apply,
                                   num_nodes=K, graph="ring", robust=RobustConfig(mu=6.0),
                                   lr=LR, device="cpu", obs=obs, sanitize=sanitize)
    state = trainer.init(convert.params_from_numpy(fmnist["params"], device="cpu"))
    stacked = tuple(np.stack(parts) for parts in zip(*fmnist["batches"]))
    return trainer.run(state, stacked, epoch_steps=8, on_epoch=lambda *a: None)


def test_sink_and_sanitizer_change_no_bit(fmnist):
    off_state, off_ms = _port_run(fmnist)
    sink = MetricsSink(vector_every=4)
    on_state, on_ms = _port_run(fmnist, obs=sink, sanitize=True)
    assert on_ms.keys() == off_ms.keys()
    for key in off_ms:
        assert torch.equal(on_ms[key], off_ms[key]), key
    for name in off_state.params:
        assert torch.equal(on_state.params[name], off_state.params[name]), name
    recs = sink.records("train")
    assert [r["step"] for r in recs] == list(range(STEPS))
    assert [r["step"] for r in recs if "loss_nodes" in r] == list(range(0, STEPS, 4))
    for r in recs:  # each record's scalars are the step's metrics
        assert r["loss_mean"] == float(off_ms["loss_mean"][r["step"]])


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def test_tap_ops_stay_within_the_queued_design(fmnist, monkeypatch):
    """The tap's dispatched ops per step (``_tap_fields`` and the queueing):
    none on an ordinary step (the drain stacks the queued 0-d metrics); on
    a vector step at most 2 ops that are not views (ef_res's clamp and
    log10) and 5 in all (the histogram inputs' reshapes).  The old tap took
    ~23 and ~88 (a detach and a reshape per field and a cat, and ~12 ops per
    histogram).  The records keep their fields."""
    counts, tap_fields = [], drdsgd._tap_fields

    def counted(*args, **kw):
        with _CountOps() as mode:
            out = tap_fields(*args, **kw)
        counts.append(mode.ops)
        return out

    monkeypatch.setattr(drdsgd, "_tap_fields", counted)
    sink = MetricsSink(vector_every=2)
    trainer = DecentralizedTrainer(nets.make_classifier_loss(nets.mlp_apply), nets.mlp_apply,
                                   num_nodes=K, graph="ring", robust=RobustConfig(mu=6.0),
                                   lr=LR, device="cpu", obs=sink)
    state = trainer.init(convert.params_from_numpy(fmnist["params"], device="cpu"))
    for batch in fmnist["batches"][:4]:
        state, _ = trainer.step(state, batch)
    vector_steps, ordinary = counts[0::2], counts[1::2]
    for ops in ordinary:
        assert ops == []
    for ops in vector_steps:
        assert len(ops) <= 5 and len([op for op in ops if not op.is_view]) <= 2, ops
    recs = sink.records("train")
    assert [sorted(r) for r in recs[1::2]] == [sorted(recs[1])] * 2
    assert {f"hist_{s.source}" for s in TRAIN_HISTOGRAMS} | {"loss_nodes", "dr_weights"} \
        <= set(recs[0]) - set(recs[1])


def test_train_records_match_the_reference(fmnist, tmp_path):
    ref_sink = RefSink(vector_every=8)
    ref_t = RefTrainer(ref_nets.make_classifier_loss(ref_nets.mlp_apply), ref_nets.mlp_apply,
                       num_nodes=K, graph="ring", robust=RefRobust(mu=6.0), lr=LR, obs=ref_sink)
    batches = tuple(jnp.asarray(np.stack(p)) for p in zip(*fmnist["batches"]))
    ref_t.run(ref_t.init(fmnist["params"]), batches)
    want = ref_sink.records("train")

    spec = TrainerSpec(num_nodes=K, graph="ring", mu=6.0, lr=LR, device="cpu")
    with MetricsSink(str(tmp_path), vector_every=8) as sink:
        trainer = spec.build(nets.make_classifier_loss(nets.mlp_apply), nets.mlp_apply,
                             obs=sink)
        state = trainer.init(convert.params_from_numpy(fmnist["params"], device="cpu"))
        it = iter(fmnist["batches"])
        run_segments(trainer, state, lambda step: next(it), STEPS, 10, obs=sink)
        got = sink.records("train")
    assert len(got) == len(want) == STEPS
    for g, w in zip(got, want):
        assert g.keys() == w.keys(), (sorted(g), sorted(w))
        for key, wv in w.items():
            if key.startswith("hist_"):
                assert g[key] == wv, (g["step"], key)
            elif isinstance(wv, (float, list)):
                np.testing.assert_allclose(g[key], wv, **TRAJ, err_msg=f"{key} {g['step']}")
            else:
                assert g[key] == wv, key
        for key in ("loss_nodes", "dr_weights"):
            if key in w:  # no value near a bin edge: equal counts are meaningful
                spec_ = next(s for s in TRAIN_HISTOGRAMS if s.source == key)
                e = port_hist.edges(spec_).numpy()
                assert np.abs(np.asarray(w[key])[:, None] - e[None, :]).min() > EDGE_GAP
    summary = ref_schema.validate_jsonl(sink.path)
    assert summary["errors"] == [] and summary["train_steps_contiguous"]
    assert summary["kinds"] == {"train": STEPS, "perf": 2}
