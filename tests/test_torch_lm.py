"""The port's LM (``repro_torch.models.TransformerLM``) against the reference's.

For the smoke configs of all ten families — qwen2 (GQA, QKV bias, tied
embeddings), h2o-danube (sliding window), gemma2 (swa/attn alternation,
both softcaps), rwkv6, grok-1 (MoE top-2, softcaps), deepseek-moe (a dense
first layer, shared and routed experts), jamba (mamba + attention, MoE on
every second layer), pixtral (patch stub) and musicgen (frame stub) — the
reference's
``TransformerLM.init(PRNGKey(0))`` is carried across with
``repro_torch.convert.params_from_numpy``, and the same numpy-made tokens go
through both: ``logits_all``, ``prefill`` (last logits and every cache
leaf) and three ``decode_step``s from the merged prefill cache, at rtol =
atol = 1e-5 (the stub frontends get the same numpy-made embeddings,
prepended; their decode continues after prefix and prompt), except the
rwkv states ``wkv`` and ``x_chan``, held at rtol
1e-5 and atol 4e-5: over four seeds they reach 1.6e-5 past rtol 1e-5 (the
channel-mix input is the O(5) residual plus a 128-wide time-mix sum taken in
another order, and ``wkv`` sums 20 decayed outer products), while every
logit stays within 5e-6; and every value of jamba, held at the same
tolerance: its logits reach |4.4|, and over four seeds the port's part from
the reference's by at most 1.7e-5 (4e-6 of the largest), where the
reference's own jitted and op-by-op forwards part by 7.2e-6.  The node-stacked loss (``make_lm_loss``: K = 2
nodes with their own weights, tokens and embeddings) and its gradient
against ``jax.vmap`` of the reference's loss, CE + MoE aux: losses at rtol
1e-5, each gradient leaf within ``GRAD_REL`` of its own largest |value|.
``num_params`` equals the reference's for every ``full()`` config; the
configs are equal field for field.  Each arch's reference model is built
and jitted once per module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_arch as ref_get_arch
from repro.models import TransformerLM as RefLM
from repro.serve.prefill import merge_prefill_cache as ref_merge
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, ALIASES, canonical, get_arch
from repro_torch.models import TransformerLM
from repro_torch.serve import merge_prefill_cache
from repro_torch.utils.tree import flatten

TOL = dict(rtol=1e-5, atol=1e-5)
STATE_TOL = dict(rtol=1e-5, atol=4e-5)  # rwkv wkv and x_chan, all of jamba (module doc)
STATE_TOL_ARCHS = ("jamba_1_5_large_398b",)
GRAD_REL = 2e-5   # a gradient leaf against its largest |value| (test_torch_lm_train.py)
SERVED = ("qwen2_0_5b", "h2o_danube_1_8b", "gemma2_27b", "rwkv6_7b", "grok_1_314b",
          "deepseek_moe_16b", "jamba_1_5_large_398b", "pixtral_12b", "musicgen_medium")
FULL_SERVED = SERVED + ("llama3_405b",)
B, S0, DECODES = 2, 20, 3


class Ref:
    """One arch's reference model, params and jitted entry points."""

    def __init__(self, arch):
        self.cfg = ref_get_arch(arch, smoke=True)
        self.model = RefLM(self.cfg)
        self.params = self.model.init(jax.random.PRNGKey(0))
        self.prefill = jax.jit(self.model.prefill)
        self.decode = jax.jit(self.model.decode_step)
        self.logits_all = jax.jit(self.model.logits_all)
        self.prefix = self.cfg.frontend_len if self.cfg.frontend != "token" else 0


@pytest.fixture(scope="module")
def refs():
    return {}


def _ref(refs, arch) -> Ref:
    if arch not in refs:
        refs[arch] = Ref(arch)
    return refs[arch]


def _tokens(vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S0)).astype(np.int64)


def _batches(ref: Ref, toks, seed=0):
    """The reference's and the port's batch: tokens, and the stub
    frontends' (..., P, D) embeddings, numpy-made."""
    r, p = {"tokens": jnp.asarray(toks, jnp.int32)}, {"tokens": torch.from_numpy(toks)}
    if ref.prefix:
        emb = (np.random.default_rng(seed + 100).standard_normal(
            toks.shape[:-1] + (ref.prefix, ref.cfg.d_model)) * 0.02).astype(np.float32)
        r["embeddings"], p["embeddings"] = jnp.asarray(emb), torch.from_numpy(emb)
    return r, p


def _port(arch, ref: Ref):
    model = TransformerLM(get_arch(arch, smoke=True))
    return model, convert.params_from_numpy(jax.tree.map(np.asarray, ref.params), device="cpu")


def _close(got, want, what, arch=None):
    tol = STATE_TOL if arch in STATE_TOL_ARCHS or what.endswith(("/wkv", "/x_chan")) else TOL
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=what, **tol)


def _flat_cache(cache):
    """The reference's cache tree (lists of dicts and dicts) -> "a/b" leaves."""
    head, groups = cache if isinstance(cache, tuple) else (cache["head"], cache["groups"])
    out = flatten({"groups": groups})
    out.update(flatten({"head": {str(i): c for i, c in enumerate(head)}}))
    return out


@pytest.mark.parametrize("arch", SERVED)
def test_params_carry_across(refs, arch):
    ref = _ref(refs, arch)
    model, params = _port(arch, ref)
    decl = model.decl()
    assert list(params) == sorted(decl)
    for name, d in decl.items():
        assert tuple(params[name].shape) == d.shape, name
    assert model.num_params() == ref.model.num_params()
    # the port's own init has the same leaves, shapes and constant values
    own = model.init(torch.Generator().manual_seed(0))
    assert list(own) == list(params)
    for name, d in decl.items():
        assert own[name].shape == params[name].shape
        if d.init != "normal":
            torch.testing.assert_close(own[name], params[name], rtol=0, atol=0)


@pytest.mark.parametrize("arch", SERVED)
def test_logits_all_matches_reference(refs, arch):
    ref = _ref(refs, arch)
    model, params = _port(arch, ref)
    toks = _tokens(ref.cfg.vocab)
    r_batch, batch = _batches(ref, toks)
    want = ref.logits_all(ref.params, r_batch)
    with torch.inference_mode():
        got = model.logits_all(params, batch)
    assert tuple(got.shape) == (B, S0, ref.cfg.vocab)
    _close(got, want, "logits_all", arch)


@pytest.mark.parametrize("arch", SERVED)
def test_prefill_and_decode_match_reference(refs, arch):
    ref = _ref(refs, arch)
    model, params = _port(arch, ref)
    toks = _tokens(ref.cfg.vocab, seed=1)
    r_batch, batch = _batches(ref, toks, seed=1)
    r_logits, r_pf = ref.prefill(ref.params, r_batch)
    with torch.inference_mode():
        logits, pf = model.prefill(params, batch)
    _close(logits, r_logits, "prefill logits", arch)
    want, got = _flat_cache(r_pf), _flat_cache(pf)
    assert sorted(want) == sorted(got)
    for name in want:
        _close(got[name], want[name], f"prefill cache {name}", arch)

    s0 = ref.prefix + S0  # the stubs' decode continues after prefix and prompt
    cache_len = s0 + DECODES
    r_cache = ref_merge(ref.model, r_pf, B, cache_len, s0)
    with torch.inference_mode():
        cache = merge_prefill_cache(model, pf, B, cache_len, s0)
    tok = np.argmax(np.asarray(r_logits), axis=-1)[:, None]
    for step in range(DECODES):
        r_logits, r_cache = ref.decode(ref.params, jnp.asarray(tok, jnp.int32),
                                       jnp.int32(s0 + step), r_cache)
        with torch.inference_mode():
            logits, cache = model.decode_step(params, torch.from_numpy(tok), s0 + step, cache)
        _close(logits, r_logits, f"decode step {step} logits", arch)
        want, got = _flat_cache(r_cache), _flat_cache(cache)
        for name in want:
            _close(got[name], want[name], f"decode step {step} cache {name}", arch)
        tok = np.argmax(np.asarray(r_logits), axis=-1)[:, None]


@pytest.mark.parametrize("arch", FULL_SERVED)
def test_full_num_params_equal_reference(arch):
    assert TransformerLM(get_arch(arch)).num_params() == RefLM(ref_get_arch(arch)).num_params()


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_configs_equal_reference_field_for_field(arch, smoke):
    got, want = get_arch(arch, smoke), ref_get_arch(arch, smoke)
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in
                                                         dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name.endswith("_dtype"):
            assert str(a).removeprefix("torch.") == np.dtype(b).name
        elif f.name == "moe":
            assert (a is None) == (b is None)
            if b is not None:
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
        else:
            assert a == b, f.name
    for method in ("group_pattern", "head_layers"):
        assert getattr(got, method)() == getattr(want, method)()
    for prop in ("n_groups", "resolved_head_dim", "pattern_len", "is_subquadratic"):
        assert getattr(got, prop) == getattr(want, prop), prop


def test_shapes_and_stand_ins_match_reference():
    from repro.models import SHAPES as REF_SHAPES
    from repro_torch.models import SHAPES

    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}
    for arch in FULL_SERVED:
        model, ref = TransformerLM(get_arch(arch)), RefLM(ref_get_arch(arch))
        got = model.param_shapes()
        want = flatten(ref.param_shapes())
        assert list(got) == sorted(want)
        for name, t in got.items():
            assert t.device.type == "meta" and tuple(t.shape) == want[name].shape, name


def test_registry_matches_reference():
    from repro.configs import ALIASES as REF_ALIASES

    assert ARCH_IDS == REF_ARCH_IDS and ALIASES == REF_ALIASES
    assert canonical("qwen2-0.5b") == "qwen2_0_5b"
    with pytest.raises(KeyError):
        canonical("gpt-5")


@pytest.mark.parametrize("arch", SERVED)
def test_node_stacked_loss_and_grad_match_reference(refs, arch):
    """make_lm_loss over K = 2 nodes, each with its own weights (the
    reference's init and a perturbed copy), tokens and stub embeddings,
    against jax.vmap of the reference's loss (CE + MoE aux) and its
    gradient."""
    from repro_torch.models import make_lm_loss

    ref = _ref(refs, arch)
    model, _ = _port(arch, ref)
    k = 2
    rng = np.random.default_rng(11)
    base = jax.tree.map(np.asarray, ref.params)
    nodes = jax.tree.map(lambda x: np.stack([x, x + (0.01 * rng.standard_normal(x.shape))
                                             .astype(x.dtype)]), base)
    toks = rng.integers(0, ref.cfg.vocab, (k, B, S0 + 1)).astype(np.int64)
    r_batch, batch = _batches(ref, toks, seed=11)

    want, want_g = jax.jit(jax.vmap(jax.value_and_grad(ref.model.loss)))(
        jax.tree.map(jnp.asarray, nodes), r_batch)
    stacked = {n: t.requires_grad_() for n, t in
               convert.params_from_numpy(nodes, device="cpu").items()}
    args = (batch["tokens"],) + ((batch["embeddings"],) if ref.prefix else ())
    got = make_lm_loss(model)(stacked, args)
    grads = torch.autograd.grad(got.sum(), list(stacked.values()))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
    if ref.cfg.moe is not None:  # the aux term is in the loss: above the CE alone
        with torch.no_grad():
            ce = [float(model.loss({n: t[i] for n, t in stacked.items()},
                                   {key: v[i] for key, v in batch.items()})) -
                  float(model._forward({n: t[i] for n, t in stacked.items()},
                                       {key: v[i] for key, v in batch.items()}, False,
                                       drop_last_token=True)[1]) for i in range(k)]
        assert all(c < float(w) for c, w in zip(ce, np.asarray(want)))
    want_g = flatten(jax.tree.map(np.asarray, want_g))
    for (name, _), g in zip(stacked.items(), grads):
        w = want_g[name]
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g.numpy() - w).max()) / scale <= GRAD_REL, name

