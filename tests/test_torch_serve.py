"""The port's static-batch serving path against the reference's.

``repro_torch.serve.greedy_generate`` must give the reference's greedy
tokens (``repro.serve.prefill.greedy_generate``) exactly, with and without
prefill, on the cases of tests/test_serve.py: qwen2 with a 12-token
prompt, gemma2 with 24 (past its 16-token window, so the swa ring buffer
wraps), rwkv6, jamba, deepseek-moe, grok-1 and the prefix frontends
(pixtral, musicgen: both paths teacher-force the prompt through decode)
with 12; the reference's parameters are
carried across and the prompts made with numpy.  ``merge_prefill_cache``
equals the reference's at the sliding-window boundary (prompt 16 and 17
against window 16, batch 1 and 2).  Also: ``sample_tokens`` (argmax at
temperature 0, the softmax's distribution above it), ``timed_generate``'s
stats keys and token counts (a prefix frontend's prompt through decode),
and the CLI on the CPU with its unported flag raising.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.launch.serve import timed_generate as ref_timed_generate
from repro.models import TransformerLM as RefLM
from repro.serve.prefill import greedy_generate as ref_greedy
from repro.serve.prefill import merge_prefill_cache as ref_merge
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.launch import serve as cli
from repro_torch.models import TransformerLM
from repro_torch.serve import greedy_generate, merge_prefill_cache, sample_tokens
from repro_torch.utils.tree import flatten

CASES = [("qwen2_0_5b", 12), ("gemma2_27b", 24), ("rwkv6_7b", 12), ("jamba_1_5_large_398b", 12),
         ("deepseek_moe_16b", 12), ("grok_1_314b", 12), ("pixtral_12b", 12),
         ("musicgen_medium", 12)]
GEN = 6


@pytest.fixture(scope="module")
def models():
    """{arch: (reference model, reference params, port model, port params)}."""
    out = {}
    for arch, _ in CASES:
        ref = RefLM(ref_get_arch(arch, smoke=True))
        params = ref.init(jax.random.PRNGKey(0))
        port = TransformerLM(get_arch(arch, smoke=True))
        out[arch] = (ref, params, port, convert.params_from_numpy(
            jax.tree.map(np.asarray, params), device="cpu"))
    return out


@pytest.mark.parametrize("use_prefill", [True, False])
@pytest.mark.parametrize("arch,prompt_len", CASES)
def test_greedy_tokens_equal_reference(models, arch, prompt_len, use_prefill):
    ref, rparams, port, params = models[arch]
    prompt = np.random.default_rng(0).integers(0, ref.cfg.vocab, (2, prompt_len))
    want = ref_greedy(ref, rparams, jnp.asarray(prompt, jnp.int32), GEN,
                      use_prefill=use_prefill)
    got = greedy_generate(port, params, torch.from_numpy(prompt), GEN,
                          use_prefill=use_prefill)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("batch,prompt_len", [(1, 16), (2, 16), (1, 17)])
def test_merge_at_window_boundary_equals_reference(models, batch, prompt_len):
    ref, rparams, port, params = models["gemma2_27b"]
    prompt = np.random.default_rng(2).integers(0, ref.cfg.vocab, (batch, prompt_len))
    cache_len = prompt_len + 5
    _, r_pf = jax.jit(ref.prefill)(rparams, {"tokens": jnp.asarray(prompt, jnp.int32)})
    want = flatten(ref_merge(ref, r_pf, batch, cache_len, prompt_len)["groups"])
    with torch.inference_mode():
        _, pf = port.prefill(params, {"tokens": torch.from_numpy(prompt)})
        got = flatten(merge_prefill_cache(port, pf, batch, cache_len, prompt_len)["groups"])
    assert sorted(got) == sorted(want)
    for name in want:
        assert tuple(got[name].shape) == want[name].shape, name
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_sample_tokens_greedy_and_distribution():
    g = torch.Generator().manual_seed(0)
    logits = torch.tensor([[0.0, 2.0, 2.0, -1.0], [1.0, 0.0, 3.0, 0.5]])
    greedy = sample_tokens(logits, g, torch.zeros(2))
    assert greedy.tolist() == [1, 2]  # the first maximal index, as jnp.argmax
    n = 20000
    rows = logits[1:].expand(n, 4)
    drawn = sample_tokens(rows, g, torch.full((n,), 2.0))
    freq = torch.bincount(drawn, minlength=4).double() / n
    want = torch.softmax(logits[1].double() / 2.0, dim=0)
    assert float((freq - want).abs().max()) < 0.02  # ~5 sigma at n = 20,000
    mixed = sample_tokens(logits, g, torch.tensor([0.0, 1.0]))
    assert int(mixed[0]) == 1


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "musicgen_medium"])
def test_timed_generate_keeps_the_reference_stats(models, arch):
    """A prefix frontend (musicgen) prefills through the decode path: the
    reference's prompt-token count, b (s0 - 1)."""
    ref, rparams, port, params = models[arch]
    prompt = np.random.default_rng(3).integers(0, ref.cfg.vocab, (2, 8))
    want_out, want = ref_timed_generate(ref, rparams, jnp.asarray(prompt, jnp.int32), 4)
    got_out, got = cli.timed_generate(port, params, torch.from_numpy(prompt), 4)
    np.testing.assert_array_equal(got_out.numpy(), np.asarray(want_out))
    for phase in ("prefill", "decode"):
        assert sorted(got[phase]) == sorted(want[phase])
        assert got[phase]["tokens"] == want[phase]["tokens"]


def test_cli_serves_on_the_cpu(capsys):
    cli.main(["--arch", "rwkv6-7b", "--smoke", "--device", "cpu", "--batch", "2",
              "--prompt-len", "6", "--gen-len", "3"])
    out = capsys.readouterr().out
    assert "generated (2, 3)" in out and "prefill: 12 prompt tok" in out


@pytest.mark.parametrize("flag", [["--engine", "--log-dir", "logs"],
                                  ["--engine", "--int8-kv", "--log-dir", "logs"],
                                  ["--engine", "--page-size", "8", "--log-dir", "logs"],
                                  ["--log-dir", "logs"]])
def test_cli_unported_flags_raise(flag, tmp_path):
    """``--log-dir``, which raised here until the tooling was ported, now
    does what the reference's does: under ``--engine`` (beside its flags,
    which tests/test_torch_engine.py holds) the engine's sink writes its
    lifecycle and heartbeat records, valid under both packages' validators,
    and the report's latency is the summary of those records; the static
    path ignores it and writes nothing."""
    from repro.obs.schema import validate_jsonl as ref_validate_jsonl
    from repro_torch.obs import load_records, serve_latency_summary, validate_jsonl

    logs = tmp_path / "logs"
    flag = [str(logs) if a == "logs" else a for a in flag]
    report = cli.main(["--arch", "qwen2_0_5b", "--smoke", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "6", "--gen-len", "3", "--horizon", "4", *flag])
    if "--engine" not in flag:
        assert report is None and not logs.exists()
        return
    path = str(logs / "telemetry.jsonl")
    for summary in (validate_jsonl(path), ref_validate_jsonl(path)):
        assert summary["errors"] == [] and set(summary["kinds"]) == {"trace", "serve"}
    assert report["completed"] == report["admitted"] > 0
    assert serve_latency_summary(load_records(path)) == report["latency"]
