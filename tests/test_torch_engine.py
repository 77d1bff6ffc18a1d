"""The port's continuous-batching engine and paged KV pool against the
reference's (``repro.serve``, ``repro.models.attention``).

Float32:
* ``paged_decode_step`` is bit-equal to ``decode_step`` over 20 steps for
  qwen2, gemma2 (its 16-token sliding-window ring wraps), rwkv6 and jamba, as
  tests/test_serve.py holds the reference.
* Engine tokens equal isolated ``greedy_generate`` per request on the
  reference test's 6-request, 3-slot trace (slot reuse, queueing, a
  length-1 prompt), for qwen2, rwkv6 (B.7's admission, a recurrent row
  cleared on reuse), gemma2 on a trace whose prompts overflow its window,
  and jamba (mamba rows placed on admission and reset for a length-1
  prompt).
* jamba's engine, float32 and int8, gives the reference engine's tokens on
  the 6-request trace from the reference's parameters; the engine refuses
  the prefix frontends with the reference's ValueError.
* On the reference's parameters, the port's engine gives the reference
  engine's tokens on that trace, and on the CLI's Poisson trace
  (``SMOKE_CLASSES``, rate 2, horizon 8, the steps clock) its report counts
  (admitted, completed, steps, per-class requests and tokens).

int8:
* ``quantize_kv_rows`` gives the reference's q and scales bit for bit
  (rows 1 to 40, D with one and two scale blocks and D not a multiple of
  128); ``paged_kv_write`` and ``paged_kv_gather`` the reference's pool and
  reads bit for bit on the same inputs; ``place_paged_prefill`` scatters
  the same prefill caches into the same pools bit for bit (qwen2, and
  gemma2 with a prompt past its window).  The quantized
  ``paged_attention_decode`` agrees at rtol 1e-4 of the largest output (the
  two frameworks round the projections differently, and a rounding can
  move a quantized entry by one step: the pools agree within one step).
* The port's int8 engine against its own float32 engine on the 6-request
  trace: tokens are equal until a request's first divergence, and a
  divergence comes only where float32's top-2 logit margin is below twice
  the int8 row's measured logit error.  The reference's own
  ``test_engine_int8_kv_parity`` fails on this tree by the same near tie
  (request 4's second token: margin 0.0034 against an error of 0.033; it
  diverges alone at batch 1 too, so no slot reuse is involved), and the
  port reproduces both engines' tokens on that trace.

Pool, scheduler and traffic: the reference's cases (the oversized request,
allocator accounting, ``pages_needed`` clamping, FIFO and release), and
``poisson_trace`` equal to the reference's for three seeds.  The CLI's
``--engine``, ``--int8-kv`` and ``--page-size`` run on the CPU.  The
report's latency counts every request when the sink's ring holds fewer
records than the run writes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import TransformerLM as RefLM
from repro.models import attention as ref_attn
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro.serve import poisson_trace as ref_poisson_trace
from repro.serve.prefill import place_paged_prefill as ref_place
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.launch import serve as cli
from repro_torch.models import TransformerLM
from repro_torch.models import attention as attn
from repro_torch.obs import MetricsSink, load_records, serve_latency_summary
from repro_torch.serve import (
    SMOKE_CLASSES,
    TRASH_PAGE,
    PageAllocator,
    Request,
    Scheduler,
    ServeEngine,
    greedy_generate,
    pages_needed,
    place_paged_prefill,
    poisson_trace,
)
from repro_torch.utils.tree import flatten, subtree

ARCHS = ("qwen2_0_5b", "gemma2_27b", "rwkv6_7b", "jamba_1_5_large_398b")
# (prompt_len, max_new, arrival_step): tests/test_serve.py's trace, 6
# requests through 3 slots
TRACE = [(6, 5, 0), (10, 4, 0), (6, 3, 2), (1, 4, 3), (10, 6, 5), (6, 2, 9)]
# gemma2: prompts past the 16-token window, rings that wrap while decoding
WINDOW_TRACE = [(14, 8, 0), (6, 5, 0), (18, 4, 1), (1, 4, 3), (17, 3, 4)]


def _requests(vocab, trace=TRACE, seed=0, cls=Request):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, (s0,)).astype(np.int32), max_new=n,
                arrival=float(arr)) for i, (s0, n, arr) in enumerate(trace)]


def _tokens(report) -> dict:
    return {c.rid: np.asarray(c.tokens).tolist() for c in report["completions"]}


@pytest.fixture(scope="module")
def port_models():
    """{arch: (port model, the port's own seeded params)} on the CPU."""
    out = {}
    for arch in ARCHS:
        model = TransformerLM(get_arch(arch, smoke=True))
        out[arch] = (model, model.init(torch.Generator().manual_seed(0)))
    return out


@pytest.fixture(scope="module")
def qwen():
    """qwen2 smoke: (reference model, reference params, port model, the
    same params in the port)."""
    ref = RefLM(ref_get_arch("qwen2_0_5b", smoke=True))
    params = ref.init(jax.random.PRNGKey(0))
    port = TransformerLM(get_arch("qwen2_0_5b", smoke=True))
    return ref, params, port, convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                                        device="cpu")


@pytest.fixture(scope="module")
def ref_engine_tokens(qwen):
    """The reference engine's float32 tokens on TRACE (3 slots, max_len 24,
    page 4), as tests/test_serve.py runs it."""
    ref, params, _, _ = qwen
    engine = RefEngine(ref, params, max_batch=3, max_len=24, page_size=4)
    return _tokens(engine.run(_requests(ref.cfg.vocab, cls=RefRequest), clock="steps"))


# -- float32 ----------------------------------------------------------------------

def _paged_setup(model, batch, max_len, page_size, *, quantized=False):
    """Paged cache + dense per-slot block tables (slot i owns pages 1 + i nb
    .. (i + 1) nb; page 0 stays the trash page)."""
    cfg = model.cfg
    kinds = sorted(({blk for blk, _ in cfg.head_layers()}
                    | {blk for blk, _ in cfg.group_pattern()}) & {"attn", "swa"})
    tables, num_pages = {}, {}
    for k in kinds:
        nb = -(-attn.paged_kv_len(cfg, k, max_len) // page_size)
        tables[k] = torch.arange(1, 1 + batch * nb).reshape(batch, nb)
        num_pages[k] = 1 + batch * nb
    cache = model.init_paged_cache(batch, num_pages, page_size, quantized=quantized,
                                   device="cpu")
    return cache, tables


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_bit_equals_contiguous(port_models, arch):
    model, params = port_models[arch]
    b, max_len, page_size, steps = 2, 24, 4, 20
    contiguous = model.init_cache(b, max_len, "cpu")
    paged, tables = _paged_setup(model, b, max_len, page_size)
    rng = np.random.default_rng(0)
    pos = torch.zeros(b, dtype=torch.int64)
    with torch.inference_mode():
        for t in range(steps):
            tok = torch.from_numpy(rng.integers(0, model.cfg.vocab, (b, 1)))
            want, contiguous = model.decode_step(params, tok, t, contiguous)
            got, paged = model.paged_decode_step(params, tok, pos, paged, tables,
                                                 max_len=max_len)
            assert torch.equal(got, want), f"step {t}"
            pos = pos + 1


@pytest.mark.parametrize("arch,trace", [("qwen2_0_5b", TRACE), ("rwkv6_7b", TRACE),
                                        ("gemma2_27b", WINDOW_TRACE),
                                        ("jamba_1_5_large_398b", TRACE)],
                         ids=["qwen2", "rwkv6", "gemma2-window", "jamba"])
def test_engine_matches_isolated_greedy(port_models, arch, trace):
    model, params = port_models[arch]
    reqs = _requests(model.cfg.vocab, trace)
    engine = ServeEngine(model, params, max_batch=3, max_len=24, page_size=4)
    report = engine.run(list(reqs), clock="steps")
    assert report["completed"] == report["admitted"] == len(reqs)
    assert "programs" not in report
    tokens = _tokens(report)
    for r in reqs:
        want = greedy_generate(model, params, torch.from_numpy(r.prompt[None].astype(np.int64)),
                               r.max_new)
        assert tokens[r.rid] == want[0].tolist(), f"rid {r.rid}"


def test_latency_counts_every_request_past_the_sinks_ring(port_models, tmp_path):
    """A sink whose ring holds fewer records than the run writes: the
    report's latency still counts every request, and equals the summary
    over the whole JSONL."""
    model, params = port_models["qwen2_0_5b"]
    reqs = _requests(model.cfg.vocab)
    with MetricsSink(str(tmp_path), ring=8) as sink:
        engine = ServeEngine(model, params, max_batch=3, max_len=24, page_size=4, sink=sink)
        report = engine.run(list(reqs), clock="steps")
        assert len(sink.records()) == 8
    written = load_records(str(tmp_path))
    # five lifecycle records per request: the ring lost most of them
    assert sum(r["kind"] == "trace" for r in written) == 5 * len(reqs)
    assert report["latency"]["requests"] == len(reqs)
    assert report["latency"] == serve_latency_summary(written)


def test_engine_matches_reference_engine(qwen, ref_engine_tokens):
    _, _, port, params = qwen
    engine = ServeEngine(port, params, max_batch=3, max_len=24, page_size=4)
    assert _tokens(engine.run(_requests(port.cfg.vocab), clock="steps")) == ref_engine_tokens


def test_steps_clock_report_matches_reference(qwen, capsys):
    """The CLI's engine run with --smoke (the steps clock) against the
    reference engine on the same trace and parameters: the same counts."""
    ref, rparams, port, params = qwen
    max_len = max(c.prompt_len + c.gen_max for c in SMOKE_CLASSES)
    want = RefEngine(ref, rparams, max_batch=4, max_len=max_len, page_size=8).run(
        ref_poisson_trace(SMOKE_CLASSES, rate=2.0, horizon=8.0, vocab=ref.cfg.vocab, seed=0),
        clock="steps")
    got = ServeEngine(port, params, max_batch=4, max_len=max_len, page_size=8).run(
        poisson_trace(SMOKE_CLASSES, rate=2.0, horizon=8.0, vocab=port.cfg.vocab, seed=0),
        clock="steps")
    for key in ("admitted", "completed", "steps"):
        assert got[key] == want[key], key
    assert _tokens(got) == _tokens(want)
    assert got["decode"]["steady_tokens"] == want["decode"]["steady_tokens"]
    assert got["prefill"]["tokens"] == want["prefill"]["tokens"]
    lat, ref_lat = got["latency"], want["latency"]
    assert (lat["requests"], lat["tokens"]) == (ref_lat["requests"], ref_lat["tokens"])
    assert {c: (d["requests"], d["tokens"]) for c, d in lat["per_class"].items()} == \
        {c: (d["requests"], d["tokens"]) for c, d in ref_lat["per_class"].items()}
    assert sorted(set(lat) - {"per_class"}) == sorted(set(ref_lat) - {"per_class"})
    # the same through the CLI (the port's own weights)
    report = cli.main(["--arch", "qwen2_0_5b", "--smoke", "--device", "cpu", "--engine",
                       "--rate", "2.0", "--horizon", "8"])
    assert report["admitted"] == want["admitted"] and report["steps"] == want["steps"]
    assert f"engine: {want['completed']}/{want['admitted']} requests" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [["--int8-kv"], ["--int8-kv", "--page-size", "4"]])
def test_cli_int8_engine_serves_on_the_cpu(capsys, flags):
    report = cli.main(["--arch", "qwen2_0_5b", "--smoke", "--device", "cpu", "--engine",
                       "--rate", "2.0", "--horizon", "4", *flags])
    assert report["completed"] == report["admitted"] > 0
    assert "latency: ttft p50" in capsys.readouterr().out


# -- int8 -------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 3, 8, 9, 18, 27, 40])
@pytest.mark.parametrize("d", [32, 96, 128, 192, 256])
def test_quantize_kv_rows_bit_equals_reference(n, d):
    rng = np.random.default_rng(n * 1000 + d)
    x = (rng.standard_normal((n, d)) * rng.uniform(0.01, 10, (n, 1))).astype(np.float32)
    x[0, : d // 4] = 0.0  # a partly zero row
    want_q, want_s = ref_attn.quantize_kv_rows(jnp.asarray(x))
    [(q, s)] = attn.quantize_kv_rows([torch.from_numpy(x)])
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))


def _random_int8_pool(rng, pages, ps, kvh, hd, blocks):
    return {"k": rng.integers(-127, 128, (pages, ps, kvh, hd)).astype(np.int8),
            "v": rng.integers(-127, 128, (pages, ps, kvh, hd)).astype(np.int8),
            "k_scale": rng.uniform(0.001, 0.1, (pages, ps, blocks)).astype(np.float32),
            "v_scale": rng.uniform(0.001, 0.1, (pages, ps, blocks)).astype(np.float32)}


def _torch_tree(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_paged_kv_write_and_gather_bit_equal_reference(quantized):
    rng = np.random.default_rng(7)
    pages, ps, kvh, hd, b, t = 10, 4, 2, 64, 3, 10  # D = 128: one scale block
    if quantized:
        pool = _random_int8_pool(rng, pages, ps, kvh, hd, 1)
    else:
        pool = {n: rng.standard_normal((pages, ps, kvh, hd)).astype(np.float32)
                for n in ("k", "v")}
    k, v = (rng.standard_normal((b, kvh, hd)).astype(np.float32) for _ in range(2))
    page_ids, offsets = np.array([3, 5, 8]), np.array([1, 0, 3])
    want = ref_attn.paged_kv_write({n: jnp.asarray(a) for n, a in pool.items()},
                                   jnp.asarray(k), jnp.asarray(v), jnp.asarray(page_ids),
                                   jnp.asarray(offsets))
    got = attn.paged_kv_write(_torch_tree(pool), torch.from_numpy(k), torch.from_numpy(v),
                              torch.from_numpy(page_ids), torch.from_numpy(offsets))
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)
    table = rng.permutation(np.arange(1, pages))[:b * 3].reshape(b, 3)
    want_kv = ref_attn.paged_kv_gather(want, jnp.asarray(table), t, jnp.float32)
    got_kv = attn.paged_kv_gather(got, torch.from_numpy(table), t, torch.float32)
    for g, w in zip(got_kv, want_kv):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_quantized_paged_attention_decode_agrees_with_reference(qwen):
    ref, rparams, port, params = qwen
    cfg = ref.cfg
    kvh, hd, b, max_len, ps = cfg.n_kv_heads, cfg.resolved_head_dim, 3, 24, 4
    nb = max_len // ps
    rng = np.random.default_rng(11)
    pool = _random_int8_pool(rng, 1 + b * nb, ps, kvh, hd, attn.kv_scale_blocks(port.cfg))
    table = np.arange(1, 1 + b * nb).reshape(b, nb)
    pos = np.array([0, 7, 23])
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    rp = jax.tree.map(lambda a: a[0], rparams["groups"]["l0"]["mix"])
    pp = {n: v[0] for n, v in subtree(params, "groups/l0/mix").items()}
    want, want_pool = ref_attn.paged_attention_decode(
        rp, jnp.asarray(x), cfg, kind="attn", pool={n: jnp.asarray(a) for n, a in pool.items()},
        table=jnp.asarray(table), pos=jnp.asarray(pos), max_len=max_len)
    got, got_pool = attn.paged_attention_decode(
        pp, torch.from_numpy(x), port.cfg, kind="attn", pool=_torch_tree(pool),
        table=torch.from_numpy(table), pos=torch.from_numpy(pos), max_len=max_len)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    for name in ("k", "v"):  # one quantization step at most
        diff = np.abs(got_pool[name].numpy().astype(int) - np.asarray(want_pool[name]).astype(int))
        assert diff.max() <= 1, name
        np.testing.assert_allclose(got_pool[name + "_scale"].numpy(),
                                   np.asarray(want_pool[name + "_scale"]), rtol=1e-5)


@pytest.mark.parametrize("arch,s0", [("qwen2_0_5b", 10), ("gemma2_27b", 21)])
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_place_paged_prefill_bit_equals_reference(arch, s0, quantized):
    """The reference's prefill caches placed by both packages into the same
    pools at the same table rows."""
    ref = RefLM(ref_get_arch(arch, smoke=True))
    rparams = ref.init(jax.random.PRNGKey(3))
    port = TransformerLM(get_arch(arch, smoke=True))
    max_len, ps, batch, slot = 24, 4, 3, 1
    prompt = np.random.default_rng(5).integers(0, ref.cfg.vocab, (1, s0 - 1)).astype(np.int32)
    _, pf = jax.jit(ref.prefill)(rparams, {"tokens": jnp.asarray(prompt)})
    cache, tables = _paged_setup(port, batch, max_len, ps, quantized=quantized)
    ref_cache = jax.tree.map(lambda a: jnp.asarray(a.numpy()), cache)
    rows = {k: v[slot] for k, v in tables.items()}
    want = ref_place(ref, pf, ref_cache, {k: jnp.asarray(v.numpy()) for k, v in rows.items()},
                     jnp.int32(slot), s0, max_len)
    head_pf, group_pf = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), pf)
    got = place_paged_prefill(port, (head_pf, group_pf), cache, rows, slot, s0, max_len)
    got_leaves, want_leaves = flatten(got["groups"]), flatten(want["groups"])
    assert sorted(got_leaves) == sorted(want_leaves)
    for name, w in want_leaves.items():
        np.testing.assert_array_equal(got_leaves[name].numpy(), np.asarray(w), err_msg=name)
    # the slot's pages were written, the others not
    assert any(bool(v.any()) for v in got_leaves.values())


def _logged_run(model, params, reqs, quantized):
    """The engine's run with each step's (active, logits) recorded."""
    engine = ServeEngine(model, params, max_batch=3, max_len=24, page_size=4,
                         quantized=quantized)
    steps, step = [], engine._step

    def logged():
        active = engine._carry["active"].clone()
        out = step()
        steps.append((active, captured.pop()))
        return out

    captured = []
    decode = model.paged_decode_step

    def capture(*args, **kw):
        logits, cache = decode(*args, **kw)
        captured.append(logits.clone())
        return logits, cache

    engine._step = logged
    object.__setattr__(model, "paged_decode_step", capture)
    try:
        report = engine.run(list(reqs), clock="steps")
    finally:
        object.__delattr__(model, "paged_decode_step")
    return report, steps, engine


def test_int8_engine_diverges_only_on_near_ties(qwen):
    """int8 against float32 on the 6-request trace, the reference's weights.
    Per request, tokens are equal up to its first divergence; there,
    float32's top-2 margin must be below twice the int8 row's measured
    logit error (both logits of the pair may move by that much)."""
    _, _, port, params = qwen
    reqs = _requests(port.cfg.vocab)
    (f32, f32_steps, e32), (i8, i8_steps, e8) = (_logged_run(port, params, reqs, q)
                                                   for q in (False, True))
    assert f32["steps"] == i8["steps"]
    slot_of = {}  # (step, slot) -> rid from the trace records
    for rec in e32.records:
        if rec.get("event") == "admitted":
            slot_of.setdefault(rec["slot"], []).append((rec["step"], rec["rid"]))

    def rid_at(step, slot):
        return max((s, r) for s, r in slot_of[slot] if s <= step)[1]

    seen = {r.rid: 0 for r in reqs}
    diverged, checked = {}, 0
    for step, ((act, lf), (act8, li)) in enumerate(zip(f32_steps, i8_steps)):
        assert torch.equal(act, act8)
        for slot in torch.nonzero(act)[:, 0].tolist():
            rid = rid_at(step, slot)
            t = seen[rid]
            seen[rid] += 1
            if rid in diverged:
                continue
            a, b = int(lf[slot].argmax()), int(li[slot].argmax())
            top = lf[slot].topk(2).values
            margin = float(top[0] - top[1])
            err = float((li[slot] - lf[slot]).abs().max())
            checked += 1
            if a != b:
                assert margin < 2 * err, (rid, t, margin, err)
                diverged[rid] = (t, margin, err)
    assert checked >= 20
    f32_tok, i8_tok = _tokens(f32), _tokens(i8)
    for r in reqs:
        t = diverged.get(r.rid, (r.max_new,))[0]
        assert i8_tok[r.rid][:t] == f32_tok[r.rid][:t], r.rid
    # the reference's failing case: request 4's second token is a near tie
    assert diverged.get(4, (None,))[0] == 1


# -- pool, scheduler, traffic (tests/test_serve.py's cases) -------------------------

@pytest.mark.parametrize("arch", ["pixtral_12b", "musicgen_medium"])
def test_engine_refuses_prefix_frontends(arch):
    model = TransformerLM(get_arch(arch, smoke=True))
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="token frontend"):
        ServeEngine(model, params, max_batch=2, max_len=24)
    with pytest.raises(ValueError, match="token frontend"):
        RefEngine(RefLM(ref_get_arch(arch, smoke=True)), None, max_batch=2, max_len=24)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_jamba_engine_matches_reference_engine(quantized):
    """jamba (mamba rows per slot, one attention layer's paged KV, MoE) on
    TRACE through the port's engine and the reference's, the same weights:
    the same tokens (the length-1 prompt resets the slot's mamba rows)."""
    ref = RefLM(ref_get_arch("jamba_1_5_large_398b", smoke=True))
    rparams = ref.init(jax.random.PRNGKey(0))
    want = _tokens(RefEngine(ref, rparams, max_batch=3, max_len=24, page_size=4,
                             quantized=quantized).run(
        _requests(ref.cfg.vocab, cls=RefRequest), clock="steps"))
    model = TransformerLM(get_arch("jamba_1_5_large_398b", smoke=True))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, rparams), device="cpu")
    got = _tokens(ServeEngine(model, params, max_batch=3, max_len=24, page_size=4,
                              quantized=quantized).run(_requests(model.cfg.vocab),
                                                       clock="steps"))
    assert got == want


def test_engine_rejects_oversized_request(port_models):
    model, params = port_models["qwen2_0_5b"]
    engine = ServeEngine(model, params, max_batch=2, max_len=8, page_size=4)
    with pytest.raises(ValueError, match="wrap their ring"):
        engine.sched.submit(Request(rid=0, prompt=np.zeros((6,), np.int32), max_new=4))


def test_page_allocator_accounting():
    a = PageAllocator(num_pages=9)          # page 0 reserved for trash
    assert a.capacity == 8 and a.free_pages == 8
    p1, p2 = a.alloc(3), a.alloc(2)
    assert len(set(p1) | set(p2)) == 5 and TRASH_PAGE not in p1 + p2
    assert a.used_pages == 5 and a.occupancy() == 5 / 8
    assert not a.can_alloc(4) and a.can_alloc(3)
    a.free(p1)
    assert a.free_pages == 6
    with pytest.raises(RuntimeError, match="double free"):
        a.free(p1 + p1)
    with pytest.raises(ValueError, match="invalid page"):
        a.free([TRASH_PAGE])
    with pytest.raises(RuntimeError, match="exhausted"):
        PageAllocator(3).alloc(3)
    with pytest.raises(ValueError, match="one is trash"):
        PageAllocator(1)


def test_pages_needed_clamps_to_ring():
    assert pages_needed(7, 4, ring_len=8, page_size=4) == 2
    assert pages_needed(3, 2, ring_len=8, page_size=4) == 1
    assert pages_needed(1, 1, ring_len=8, page_size=4) == 1


def test_scheduler_fifo_and_release():
    sched = Scheduler(max_batch=2, page_size=4, num_pages={"attn": 4}, ring_len={"attn": 16})

    def req(rid, s0, n):
        return Request(rid=rid, prompt=np.zeros((s0,), np.int32), max_new=n)

    sched.submit(req(0, 8, 4))      # needs ceil(11/4) = 3 pages (all of them)
    sched.submit(req(1, 8, 4))
    sched.submit(req(2, 2, 2))      # 1 page, but FIFO: waits behind rid 1
    a0 = sched.next_admission()
    assert a0.req.rid == 0 and len(a0.pages["attn"]) == 3
    assert sched.next_admission() is None       # head-of-line blocking
    assert sched.queued == 2 and sched.active_slots == 1
    assert sched.occupancy() == 1.0
    sched.release(a0.slot)
    a1 = sched.next_admission()
    assert a1.req.rid == 1 and a1.slot == a0.slot   # slot reuse
    assert sched.next_admission() is None
    sched.release(a1.slot)
    assert sched.next_admission().req.rid == 2
    with pytest.raises(ValueError, match="only has"):
        sched.submit(req(3, 12, 4))
    with pytest.raises(ValueError, match="wrap their ring"):
        sched.submit(req(4, 16, 9))
    assert Scheduler(1, 4, {}, {}).occupancy() == 0.0  # no attention kinds (rwkv)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_poisson_trace_equals_reference(seed):
    for rate, horizon in ((2.0, 8.0), (0.5, 40.0)):
        got = poisson_trace(SMOKE_CLASSES, rate=rate, horizon=horizon, vocab=512, seed=seed)
        want = ref_poisson_trace(SMOKE_CLASSES, rate=rate, horizon=horizon, vocab=512,
                                 seed=seed)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert (g.rid, g.max_new, g.temperature, g.arrival, g.cls) == \
                (w.rid, w.max_new, w.temperature, w.arrival, w.cls)
            np.testing.assert_array_equal(g.prompt, w.prompt)
