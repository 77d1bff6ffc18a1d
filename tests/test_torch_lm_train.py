"""LM training in the port against the reference, on the CPU.

The reference's weights (``TransformerLM.init(PRNGKey(0))``) are carried
across with ``repro_torch.convert.params_from_numpy``, and the same
numpy-made tokens go through both packages.

- ``chunked_logits_xent``: value and gradients (x and the table) at rtol
  1e-5, with a softcap, a mask and a remainder chunk.
- ``TransformerLM.loss`` and its gradient against
  ``jax.value_and_grad(model.loss)`` on the smoke configs of qwen2 (GQA,
  QKV bias, tied embeddings), h2o-danube (sliding window), gemma2 (both
  softcaps) and rwkv6: the loss at rtol 1e-5, each gradient leaf within
  ``GRAD_REL`` of its own largest |value| (measured: at most 3.5e-6; the
  two frameworks sum the float32 products of the backward in other orders).
- The attention gradient: the port's ``chunked_attention`` (autograd
  through its plain version on the CPU) against ``jax.grad`` of the
  reference's chunked attention, dq, dk and dv within ``GRAD_REL`` of their
  largest |value|.
- The token streams equal the reference's.
- A K = 4 ring, 5-step DR-DSGD (clipped at norm 1, ``train_lm``'s
  setting) and DSGD (unclipped) trajectory on qwen2-smoke against the
  reference's ``build_train_step(model.loss, sgd(1e-2),
  make_dense_mixer(w), ...)`` as ``tests/test_arch_smoke.py`` builds it:
  params and every metric at rtol 1e-5, atol 1e-6 (slice 1's tolerance).
  The port's step runs through the fused gossip update's plain version.
- The same trajectory (K = 2, 3 steps, clipped DR-DSGD) for deepseek-moe
  (the aux term in every node's loss), jamba (mamba + attention, MoE) and
  musicgen (the frame stub's embeddings, drawn as ``train_lm`` draws them).
- The ``--arch`` CLI runs on the CPU and its losses are finite; for a stub
  frontend it hands every step the reference's embeddings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.core import RobustConfig as RefRobust
from repro.core import TrainStepConfig as RefStepConfig
from repro.core import build_train_step as ref_build_train_step
from repro.core import make_dense_mixer as ref_make_dense_mixer
from repro.core.drdsgd import init_state as ref_init_state
from repro.core.drdsgd import replicate_params as ref_replicate
from repro.data import make_node_token_streams as ref_streams
from repro.models import TransformerLM as RefLM
from repro.models.attention import chunked_attention as ref_chunked_attention
from repro.models.layers import chunked_logits_xent as ref_xent
from repro.optim import sgd as ref_sgd
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core import RobustConfig, TrainStepConfig, build_train_step
from repro_torch.core.consensus import make_dense_mixer
from repro_torch.core.drdsgd import init_state, replicate_params
from repro_torch.data import make_node_token_streams
from repro_torch.graphs import metropolis_weights, ring_graph
from repro_torch.models import TransformerLM, make_lm_loss
from repro_torch.models.attention import chunked_attention
from repro_torch.models.layers import chunked_logits_xent
from repro_torch.optim import sgd

GRAD_REL = 2e-5   # a gradient leaf against its largest |value| (module doc)
TRAJ = dict(rtol=1e-5, atol=1e-6)
B, S = 2, 24


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got: torch.Tensor, want) -> float:
    want = torch.from_numpy(np.array(want, dtype=np.float32))
    scale = float(want.abs().max())
    return float((got.detach() - want).abs().max()) / max(scale, 1e-30)


@pytest.mark.parametrize("num_nodes,vocab,seed,hetero", [(4, 1000, 0, True), (3, 151936, 2, True),
                                                        (2, 64, 1, False)])
def test_token_streams_equal_reference(num_nodes, vocab, seed, hetero):
    ours = make_node_token_streams(num_nodes, vocab, seed=seed, hetero=hetero)
    theirs = ref_streams(num_nodes, vocab, seed=seed, hetero=hetero)
    for _ in range(3):
        for a, b in zip(ours, theirs):
            got, want = a.next_batch(2, 17), b.next_batch(2, 17)
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("s,chunk,cap,masked", [(37, 16, None, False), (37, 16, 30.0, True),
                                                (32, 64, None, True), (48, 16, 5.0, False)])
def test_chunked_logits_xent_matches_reference(s, chunk, cap, masked):
    rng = np.random.default_rng(s + chunk)
    d, v = 16, 50
    x = rng.standard_normal((B, s, d)).astype(np.float32)
    table = (rng.standard_normal((v, d)) * 0.5).astype(np.float32)
    labels = rng.integers(0, v, (B, s)).astype(np.int32)
    mask = (rng.random((B, s)) < 0.7).astype(np.float32) if masked else None

    def ref_fn(x, table):
        return ref_xent(x, table, labels, mask, chunk=chunk, logit_softcap_val=cap)

    want, (want_dx, want_dt) = jax.value_and_grad(ref_fn, argnums=(0, 1))(x, table)
    xt, tt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(table).requires_grad_()
    got = chunked_logits_xent(xt, tt, torch.from_numpy(labels),
                              None if mask is None else torch.from_numpy(mask),
                              chunk=chunk, logit_softcap_val=cap)
    got_dx, got_dt = torch.autograd.grad(got, (xt, tt))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(want_dx), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got_dt.numpy(), np.asarray(want_dt), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "h2o_danube_1_8b", "gemma2_27b", "rwkv6_7b"])
def test_loss_and_grad_match_reference(arch):
    ref = RefLM(ref_get_arch(arch, smoke=True))
    ref_params = ref.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(3).integers(0, ref.cfg.vocab, (B, S + 1)).astype(np.int32)
    want, want_g = jax.jit(jax.value_and_grad(ref.loss))(ref_params, {"tokens": toks})
    want_g = convert.params_from_numpy(_np(want_g), device="cpu")

    model = TransformerLM(get_arch(arch, smoke=True))
    params = {n: t.requires_grad_() for n, t in
              convert.params_from_numpy(_np(ref_params), device="cpu").items()}
    got = model.loss(params, {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(got, list(params.values()))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert sorted(params) == sorted(want_g)
    for name, g in zip(params, grads):
        err = _rel(g, want_g[name].numpy())
        assert err <= GRAD_REL, (arch, name, err)


@pytest.mark.parametrize("s,g,window,cap", [(16, 2, None, None), (24, 1, 8, None),
                                            (20, 3, None, 20.0), (32, 2, 5, 7.0)])
def test_attention_grad_matches_reference(s, g, window, cap):
    rng = np.random.default_rng(s * 10 + g)
    kvh, hd = 2, 16
    q = rng.standard_normal((B, s, kvh, g, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, s, kvh, hd)).astype(np.float32) for _ in range(2))
    cot = rng.standard_normal((B, s, kvh, g, hd)).astype(np.float32)
    pos = jnp.arange(s, dtype=jnp.int32)

    def ref_fn(q, k, v):
        out = ref_chunked_attention(q, k, v, pos, pos, window=window, softcap_val=cap,
                                    q_chunk=8, kv_chunk=8)
        return jnp.sum(out * cot)

    want = jax.grad(ref_fn, argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = chunked_attention(qt, kt, vt, window=window, softcap_val=cap)
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), (qt, kt, vt))
    for name, a, b in zip("qkv", got, want):
        err = _rel(a, b)
        assert err <= GRAD_REL, (name, err)


@pytest.mark.parametrize("s,g,window,cap", [(24, 4, None, None), (17, 2, 6, 10.0)])
def test_attention_hd32_matches_reference(s, g, window, cap):
    """Head dim 32 (examples/torch_train_lm_drdsgd.py's width, where B.6 runs
    on the card): the forward at rtol 1e-5 and dq, dk, dv within GRAD_REL."""
    rng = np.random.default_rng(s * 32 + g)
    kvh, hd = 2, 32
    q = rng.standard_normal((B, s, kvh, g, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, s, kvh, hd)).astype(np.float32) for _ in range(2))
    cot = rng.standard_normal((B, s, kvh, g, hd)).astype(np.float32)
    pos = jnp.arange(s, dtype=jnp.int32)

    def ref_out(q, k, v):
        return ref_chunked_attention(q, k, v, pos, pos, window=window, softcap_val=cap,
                                     q_chunk=8, kv_chunk=8)

    want_out = ref_out(q, k, v)
    want = jax.grad(lambda *a: jnp.sum(ref_out(*a) * cot), argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = chunked_attention(qt, kt, vt, window=window, softcap_val=cap)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=1e-5,
                               atol=1e-5)
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), (qt, kt, vt))
    for name, a, b in zip("qkv", got, want):
        err = _rel(a, b)
        assert err <= GRAD_REL, (name, err)


@pytest.mark.parametrize("robust,grad_clip", [(True, 1.0), (False, None)])
def test_trajectory_matches_reference(robust, grad_clip):
    k, steps, lr = 4, 5, 1e-2
    cfg = ref_get_arch("qwen2_0_5b", smoke=True)
    ref = RefLM(cfg)
    ref_params = ref.init(jax.random.PRNGKey(0))
    w = metropolis_weights(ring_graph(k))
    streams = make_node_token_streams(k, cfg.vocab, seed=0)
    batches = [np.stack([s.next_batch(B, S) for s in streams]) for _ in range(steps)]

    ref_step = jax.jit(ref_build_train_step(
        ref.loss, ref_sgd(lr), ref_make_dense_mixer(w),
        RefStepConfig(robust=RefRobust(mu=6.0, enabled=robust), grad_clip=grad_clip)))
    ref_state = ref_init_state(ref_replicate(ref_params, k), ref_sgd(lr))

    model = TransformerLM(get_arch("qwen2_0_5b", smoke=True))
    mixer = make_dense_mixer(w, device="cpu")
    step = build_train_step(make_lm_loss(model), sgd(lr), mixer,
                            TrainStepConfig(robust=RobustConfig(mu=6.0, enabled=robust),
                                            grad_clip=grad_clip))
    params = convert.params_from_numpy(_np(ref_params), device="cpu")
    state = init_state(replicate_params(params, k), sgd(lr), mixer)
    for t in range(steps):
        ref_state, ref_m = ref_step(ref_state, {"tokens": batches[t]})
        state, m = step(state, (torch.from_numpy(batches[t]),))
        want = convert.params_from_numpy(_np(ref_state.params), device="cpu")
        for name, p in state.params.items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), **TRAJ,
                                       err_msg=f"step {t} {name}")
        common = set(m) & set(ref_m)
        assert {"loss_mean", "loss_worst", "robust_objective", "comm_bytes",
                "disagreement", "scale_max"} <= common
        for key in common:
            np.testing.assert_allclose(float(m[key]), float(ref_m[key]), **TRAJ,
                                       err_msg=f"step {t} {key}")


def test_cli_arch_runs_on_the_cpu(capsys):
    from repro_torch.launch import train

    trainer, state, history = train.main(["--arch", "qwen2_0_5b", "--smoke", "--steps", "3",
                                          "--nodes", "4", "--device", "cpu", "--log-every", "1"])
    assert [r["step"] for r in history] == [0, 1, 2]
    assert all(np.isfinite(r[key]) for r in history for key in ("loss_mean", "loss_worst",
                                                                 "robust_objective"))
    assert trainer.num_nodes == 4 and trainer.grad_clip == 1.0
    assert state.step == 3 and all(bool(torch.isfinite(p).all()) for p in state.params.values())
    # the console line is the sink's format_train over the step's record
    assert "step     0 loss_mean=" in capsys.readouterr().out


def _lm_batches(cfg, k, steps, seed=0):
    """train_lm's batches: each node's token stream, and for the stub
    frontends (K, B, P, D) embeddings drawn as both CLIs draw them."""
    streams = make_node_token_streams(k, cfg.vocab, seed=seed)
    rng = np.random.default_rng(seed)
    prefix = cfg.frontend_len if cfg.frontend != "token" else 0
    out = []
    for _ in range(steps):
        toks = np.stack([s.next_batch(B, S) for s in streams])
        emb = (rng.standard_normal((k, B, prefix, cfg.d_model)).astype(np.float32) * 0.02
               if prefix else None)
        out.append((toks, emb))
    return out


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "jamba_1_5_large_398b", "musicgen_medium"])
def test_family_trajectory_matches_reference(arch):
    """DR-DSGD clipped at 1 (train_lm's stack) on K = 2 nodes, 3 steps: an
    MoE model (the aux term in every node's loss), the mamba + attention
    hybrid and a frame-stub model with its embeddings."""
    k, steps, lr = 2, 3, 1e-2
    cfg = ref_get_arch(arch, smoke=True)
    ref = RefLM(cfg)
    ref_params = ref.init(jax.random.PRNGKey(0))
    w = metropolis_weights(ring_graph(k))
    batches = _lm_batches(cfg, k, steps)
    robust = RefRobust(mu=6.0)
    ref_step = jax.jit(ref_build_train_step(ref.loss, ref_sgd(lr), ref_make_dense_mixer(w),
                                            RefStepConfig(robust=robust, grad_clip=1.0)))
    ref_state = ref_init_state(ref_replicate(ref_params, k), ref_sgd(lr))
    model = TransformerLM(get_arch(arch, smoke=True))
    mixer = make_dense_mixer(w, device="cpu")
    step = build_train_step(make_lm_loss(model), sgd(lr), mixer,
                            TrainStepConfig(robust=RobustConfig(mu=6.0), grad_clip=1.0))
    state = init_state(replicate_params(convert.params_from_numpy(_np(ref_params), device="cpu"),
                                        k), sgd(lr), mixer)
    for t, (toks, emb) in enumerate(batches):
        ref_batch = {"tokens": toks} if emb is None else {"tokens": toks, "embeddings": emb}
        ref_state, ref_m = ref_step(ref_state, ref_batch)
        args = (torch.from_numpy(toks),) + (() if emb is None else (torch.from_numpy(emb),))
        state, m = step(state, args)
        want = convert.params_from_numpy(_np(ref_state.params), device="cpu")
        for name, p in state.params.items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), **TRAJ,
                                       err_msg=f"step {t} {name}")
        for key in ("loss_mean", "loss_worst", "robust_objective", "scale_max"):
            np.testing.assert_allclose(float(m[key]), float(ref_m[key]), **TRAJ,
                                       err_msg=f"step {t} {key}")


def test_cli_hands_the_stub_frontends_their_embeddings(monkeypatch):
    """``train --arch musicgen_medium --smoke``: every step's batch carries
    (K, B, P, D) embeddings drawn as the reference's train_lm draws them."""
    from repro_torch.launch import train

    seen = []
    run = train.run_segments

    def recording(trainer, state, sample_batch, *a, **kw):
        def sample(step):
            batch = sample_batch(step)
            seen.append(batch)
            return batch
        return run(trainer, state, sample, *a, **kw)

    monkeypatch.setattr(train, "run_segments", recording)
    _, state, history = train.main(["--arch", "musicgen_medium", "--smoke", "--steps", "2",
                                    "--nodes", "2", "--seq-len", str(S), "--batch-per-node",
                                    str(B), "--device", "cpu", "--log-every", "1"])
    cfg = get_arch("musicgen_medium", smoke=True)
    want = _lm_batches(cfg, 2, 2)
    assert len(seen) == 2 and state.step == 2
    for (toks, emb), (want_toks, want_emb) in zip(seen, want):
        np.testing.assert_array_equal(toks, want_toks)
        assert emb.shape == (2, B, cfg.frontend_len, cfg.d_model)
        np.testing.assert_array_equal(emb, want_emb)
    assert all(np.isfinite(r["loss_mean"]) for r in history)
