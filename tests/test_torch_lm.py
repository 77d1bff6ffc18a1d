"""The port's LM (``repro_torch.models.TransformerLM``) against the reference's.

For the smoke configs of the families the serving slice covers — qwen2
(GQA, QKV bias, tied embeddings), h2o-danube (sliding window), gemma2
(swa/attn alternation, both softcaps) and rwkv6 — the reference's
``TransformerLM.init(PRNGKey(0))`` is carried across with
``repro_torch.convert.params_from_numpy``, and the same numpy-made tokens go
through both: ``logits_all``, ``prefill`` (last logits and every cache
leaf) and three ``decode_step``s from the merged prefill cache, at rtol =
atol = 1e-5, except the rwkv states ``wkv`` and ``x_chan``, held at rtol
1e-5 and atol 4e-5: over four seeds they reach 1.6e-5 past rtol 1e-5 (the
channel-mix input is the O(5) residual plus a 128-wide time-mix sum taken in
another order, and ``wkv`` sums 20 decayed outer products), while every
logit stays within 5e-6.  ``num_params`` equals the reference's for every ``full()``
config the port serves; the configs are equal field for field; and the
families that wait for later slices raise.  Each arch's reference model is
built and jitted once per module.
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
STATE_TOL = dict(rtol=1e-5, atol=4e-5)  # rwkv wkv and x_chan (module doc)
SERVED = ("qwen2_0_5b", "h2o_danube_1_8b", "gemma2_27b", "rwkv6_7b")
FULL_SERVED = SERVED + ("llama3_405b",)
WAITING = {"grok_1_314b": "moe", "deepseek_moe_16b": "moe",
           "jamba_1_5_large_398b": "mamba", "pixtral_12b": "patch_stub",
           "musicgen_medium": "frame_stub"}
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


@pytest.fixture(scope="module")
def refs():
    return {}


def _ref(refs, arch) -> Ref:
    if arch not in refs:
        refs[arch] = Ref(arch)
    return refs[arch]


def _tokens(vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S0)).astype(np.int64)


def _port(arch, ref: Ref):
    model = TransformerLM(get_arch(arch, smoke=True))
    return model, convert.params_from_numpy(jax.tree.map(np.asarray, ref.params), device="cpu")


def _close(got, want, what):
    tol = STATE_TOL if what.endswith(("/wkv", "/x_chan")) else TOL
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
    want = ref.logits_all(ref.params, {"tokens": jnp.asarray(toks, jnp.int32)})
    with torch.inference_mode():
        got = model.logits_all(params, {"tokens": torch.from_numpy(toks)})
    _close(got, want, "logits_all")


@pytest.mark.parametrize("arch", SERVED)
def test_prefill_and_decode_match_reference(refs, arch):
    ref = _ref(refs, arch)
    model, params = _port(arch, ref)
    toks = _tokens(ref.cfg.vocab, seed=1)
    r_logits, r_pf = ref.prefill(ref.params, {"tokens": jnp.asarray(toks, jnp.int32)})
    with torch.inference_mode():
        logits, pf = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    _close(logits, r_logits, "prefill logits")
    want, got = _flat_cache(r_pf), _flat_cache(pf)
    assert sorted(want) == sorted(got)
    for name in want:
        _close(got[name], want[name], f"prefill cache {name}")

    cache_len = S0 + DECODES
    r_cache = ref_merge(ref.model, r_pf, B, cache_len, S0)
    with torch.inference_mode():
        cache = merge_prefill_cache(model, pf, B, cache_len, S0)
    tok = np.argmax(np.asarray(r_logits), axis=-1)[:, None]
    for step in range(DECODES):
        r_logits, r_cache = ref.decode(ref.params, jnp.asarray(tok, jnp.int32),
                                       jnp.int32(S0 + step), r_cache)
        with torch.inference_mode():
            logits, cache = model.decode_step(params, torch.from_numpy(tok), S0 + step, cache)
        _close(logits, r_logits, f"decode step {step} logits")
        want, got = _flat_cache(r_cache), _flat_cache(cache)
        for name in want:
            _close(got[name], want[name], f"decode step {step} cache {name}")
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


@pytest.mark.parametrize("arch", sorted(WAITING))
def test_waiting_families_raise(arch):
    with pytest.raises(NotImplementedError, match=WAITING[arch]):
        TransformerLM(get_arch(arch, smoke=True))

