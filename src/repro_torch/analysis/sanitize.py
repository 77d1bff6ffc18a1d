"""Runtime invariant checks inside the train step (the port of
``repro.analysis.sanitize``).

The static linter (``repro_torch.analysis.lint``) catches structural
hazards; this module catches *numerical* protocol violations while the real
program runs:

* the round's mixing matrix W is doubly stochastic (rows AND columns sum to
  1 — Assumption 5; a dropout renormalization bug shows up here first),
* the CHOCO error-feedback invariant Σ_i ŝ_i = Σ_i θ̂_i holds within a drift
  bound (the incremental ``hat_mix`` cache is consistent with the public
  copies it claims to mix),
* the mixed parameters are finite after the round's dequantize-accumulate,
* the codec rate stays inside its container (qmax in [1, 127] on the int8
  wire, kept-ratio in (0, 1]),
* dynamic link masks are exactly {0, 1}.

PyTorch has no checkify.  Each check instead writes into a small tensor of
its own on the device (:class:`SanitizeFlags`): the first step it failed
at, or −1, and a value measured there.  The step never waits for them; the
trainer reads every flag in one device-to-host copy at the end of a segment
(:meth:`SanitizeFlags.throw`) and raises once, naming the checks and their
steps, as the reference's batched ``errs.throw()`` does.  (A device-side
assert would poison the CUDA context.)  The checks only read what the
round computed, so a clean run's trajectory is the same bits with the
sanitizer on or off.
"""

from __future__ import annotations

import torch

from repro_torch.utils.tree import leaf_names

# Doubly-stochastic tolerance: renormalized dropout weights accumulate a few
# ulps per row; 1e-4 is ~3 orders above observed f32 noise and well below
# any real renormalization bug (a single dropped-and-unreturned link shifts
# a row sum by O(W_ij) ~ 1e-1).
_W_ATOL = 1e-4
# CHOCO drift: |Σ(ŝ − θ̂)| per leaf, relative to the public-copy scale.
_DRIFT_RTOL = 1e-3
_DRIFT_ATOL = 1e-3


class SanitizeError(RuntimeError):
    """A sanitizer check failed; ``fired`` maps each failed check to
    (first failing step, the value measured there)."""

    def __init__(self, message: str, fired: dict):
        super().__init__(message)
        self.fired = fired


class SanitizeFlags:
    """Per-check device flags: the first failing step (−1 while clean) and
    the value measured at that step, each a 0-d tensor on the step's
    device.  ``record`` stages a check without a synchronisation;
    ``throw`` reads them all in one copy."""

    def __init__(self):
        self._flags: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}
        self._say: dict[str, object] = {}

    def record(self, name: str, ok: torch.Tensor, step: int, value: torch.Tensor, say) -> None:
        """Stage check ``name`` for ``step``: ``ok`` a 0-d bool tensor,
        ``value`` a 0-d tensor kept from the first failing step, ``say`` a
        function of that value giving the message."""
        if name not in self._flags:
            self._flags[name] = (torch.full((), -1, dtype=torch.int64, device=ok.device),
                                 torch.zeros((), dtype=torch.float32, device=ok.device))
        flag, val = self._flags[name]
        first = (flag < 0) & ~ok
        self._flags[name] = (torch.where(first, step, flag),
                             torch.where(first, value.float(), val))
        self._say[name] = say

    def fired(self) -> dict:
        """{check: (step, value)} of every check that failed (one
        device-to-host copy; nothing to read while no check is staged)."""
        if not self._flags:
            return {}
        names = list(self._flags)
        flat = torch.stack([t.double() for n in names for t in self._flags[n]]).cpu().tolist()
        out = {}
        for i, name in enumerate(names):
            step, value = int(flat[2 * i]), flat[2 * i + 1]
            if step >= 0:
                out[name] = (step, value)
        return out

    def throw(self) -> None:
        """Raise :class:`SanitizeError` if any check failed, naming each
        failed check and its first failing step; the flags are cleared
        either way."""
        fired = self.fired()
        self._flags = {}
        if not fired:
            return
        lines = [f"sanitize: step {step}: {name}: {self._say[name](value)}"
                 for name, (step, value) in sorted(fired.items(), key=lambda kv: kv[1][0])]
        raise SanitizeError("\n".join(lines), fired)


def _unwrap(mixer):
    """Peel wrapper mixers (LocalUpdateMixer, RepeatMixer) to the consensus
    operator that owns W and the codec."""
    seen = set()
    while hasattr(mixer, "inner") and id(mixer) not in seen:
        seen.add(id(mixer))
        mixer = mixer.inner
    return mixer


def _round_w(target, prev_comm):
    """The (K, K) mixing matrix the round ran under, or None."""
    if hasattr(target, "_round_topology_w"):
        # time-varying stacks: W_r of THIS round (prev_comm.rounds is the
        # clock the mixer read), replayed from its per-round seed
        return target._round_topology_w(prev_comm.rounds)
    w = getattr(target, "w", None)
    return None if w is None else w.float()


def check_doubly_stochastic(w: torch.Tensor, flags: SanitizeFlags, step: int) -> None:
    err = torch.maximum((w.sum(1) - 1.0).abs().max(), (w.sum(0) - 1.0).abs().max())
    flags.record("doubly_stochastic", err < _W_ATOL, step, err,
                 lambda e: f"W rows or cols do not sum to 1 (max |err| = {e:.3g}) — the "
                           "mixing matrix is not doubly stochastic (Assumption 5)")


def _first_bad(oks: list[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """(all ok, index of the first not ok) over 0-d bool tensors."""
    ok = torch.stack(oks)
    return ok.all(), torch.argmax((~ok).int())


def check_finite_tree(tree: dict, what: str, flags: SanitizeFlags, step: int) -> None:
    names = [n for n in leaf_names(tree) if tree[n].is_floating_point()]
    if not names:
        return
    ok, bad = _first_bad([torch.isfinite(tree[n]).all() for n in names])
    flags.record("finite", ok, step, bad,
                 lambda i: f"non-finite values in {what}{names[int(i)]}")


def check_choco_invariant(comm, flags: SanitizeFlags, step: int) -> None:
    """Σ_i ŝ_i == Σ_i θ̂_i per leaf: the mixed public copies are a mixing
    of the public copies (W doubly stochastic preserves the node sum; the
    incremental delta recursion must preserve it too)."""
    if not isinstance(comm.hat, dict) or not isinstance(comm.hat_mix, dict):
        return
    names = leaf_names(comm.hat)
    oks = []
    for n in names:
        hs = comm.hat[n].float().sum(0)
        ss = comm.hat_mix[n].float().sum(0)
        oks.append((ss - hs).abs().max() <= _DRIFT_ATOL + _DRIFT_RTOL * hs.abs().max())
    ok, bad = _first_bad(oks)
    flags.record("choco_invariant", ok, step, bad,
                 lambda i: f"CHOCO invariant violated at hat/{names[int(i)]} — "
                           "max |sum(s) - sum(theta_hat)| is past the drift bound; the "
                           "hat_mix cache is stale or the delta recursion dropped mass")


def check_masks_binary(masks, flags: SanitizeFlags, step: int) -> None:
    masks = list(masks)
    if not masks:
        return
    ok, bad = _first_bad([((m == 0.0) | (m == 1.0)).all() for m in masks])
    flags.record("masks_binary", ok, step, bad,
                 lambda i: f"matching {int(i)} link mask is not in {{0, 1}}")


def check_rate_in_container(target, prev_comm, flags: SanitizeFlags, step: int) -> None:
    rate_fn = getattr(target, "_rate", None)
    compression = getattr(target, "compression", None)
    if rate_fn is None or compression is None:
        return
    rate = rate_fn(prev_comm)
    if rate is None:
        return
    if compression.kind in ("int8", "int4"):
        flags.record("rate_in_container", (rate >= 1.0) & (rate <= 127.0), step, rate,
                     lambda r: f"qmax {r:g} outside the int8 container [1, 127]")
    else:
        flags.record("rate_in_container", (rate > 0.0) & (rate <= 1.0), step, rate,
                     lambda r: f"kept-ratio {r:g} outside (0, 1]")


def step_checks(mixer, prev_comm, theta_mixed, comm, flags: SanitizeFlags, step: int) -> None:
    """Stage every applicable invariant check for one consensus round.

    Args:
      mixer: the trainer's mixer (wrappers are unwrapped here).
      prev_comm: the CommState the round CONSUMED (its ``rounds`` counter
        selects the round's W).
      theta_mixed: the round's output parameters.
      comm: the CommState the round produced.
      flags: where the checks write.
      step: the optimizer step (a host int).
    """
    target = _unwrap(mixer)
    check_finite_tree(theta_mixed, "mixed params at ", flags, step)
    w = _round_w(target, prev_comm)
    if w is not None:
        check_doubly_stochastic(w, flags, step)
        if hasattr(target, "_round_vectors"):
            _, _, masks = target._round_vectors(w)
            check_masks_binary(masks, flags, step)
    check_choco_invariant(comm, flags, step)
    check_rate_in_container(target, prev_comm, flags, step)
