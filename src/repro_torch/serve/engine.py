"""Continuous-batching decode engine over a paged (optionally int8) KV pool
(the port of ``repro.serve.engine``).

The batch is a fixed set of ``max_batch`` slots.  What changes as requests
arrive, finish or hit EOS is per-slot state on the device:

  ====================  =========  ==============================================
  tensor                shape      role
  ====================  =========  ==============================================
  ``tok``               (B, 1)     each slot's last token (next input)
  ``pos``               (B,)       per-slot decode position
  ``active``            (B,)       slot occupancy mask (gates sampling + finish)
  ``limit``             (B,)       last position a slot may decode (budget)
  ``temp``              (B,)       per-slot sampling temperature (0 = greedy)
  ``tables[kind]``      (B, NB)    block tables into the shared page pools
  ====================  =========  ==============================================

The carry (cache and the per-slot tensors) stays on the device and each
step advances it there; the host's per-step traffic is one device-to-host
copy of the (2, B) step output (sampled tokens and the next active mask).
The host writes slot rows only on the transitions: admission sets a slot's
rows, eviction points its table row back at the trash page.  Admission runs
``model.prefill`` on the prompt's first s0 - 1 tokens (B.6 on every attn
layer, B.7 on every rwkv layer, on the card) and scatters the caches into
the pools (int8 pools through B.2); the shared decode step then produces
the first token from the last prompt token.  Sampling draws from one
``torch.Generator`` per engine.

Slot and page lifecycle: admission reserves the request's worst-case page
count from the per-kind free lists and writes its block-table row; eviction
(EOS or budget, decided on the device through the active mask) frees the
pages on the host only; the next admission's prefill overwrites them.
Inactive slots keep decoding into the trash page (page 0), masked and
never read.

Observability: the engine always owns a :class:`repro_torch.obs.MetricsSink`
(in-memory unless one with a log directory is passed) and writes the request
lifecycle into it as the reference's ``trace`` records — ``queued`` →
``admitted`` → ``prefill`` → ``first_token`` → ``finished``, with slot ids,
page reservations and run-relative times; the ``finished`` record carries
the request's latency accounting (``queued_s``/``ttft_s``/``per_token_s``),
and the report's ``latency`` is :func:`repro_torch.obs.serve_latency_summary`
over every ``finished`` record of the run, which the engine keeps beside
the sink (the sink's ring holds only its newest records; its JSONL holds
them all).  Every ``log_every`` steps a ``serve`` record joins them.  The decode step, the sampling and the
admission prefill run inside ``obs:serve/decode``, ``obs:serve/sample`` and
``obs:serve/prefill`` profiler ranges.  The report has no ``programs`` key:
eager PyTorch compiles no program per shape, so there is no recompile
watchdog.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.models import TransformerLM
from repro_torch.models.attention import paged_kv_len
from repro_torch.obs.profiler import scope
from repro_torch.obs.report import serve_latency_summary
from repro_torch.obs.sink import MetricsSink
from repro_torch.serve.pool import TRASH_PAGE
from repro_torch.serve.prefill import clear_slot_state, place_paged_prefill
from repro_torch.serve.sampling import sample_tokens
from repro_torch.serve.scheduler import Admission, Request, Scheduler


@dataclasses.dataclass
class Completion:
    """One finished request with its open-loop timing (seconds from run
    start; ``arrival`` is in trace clock units — seconds or steps)."""

    rid: int
    cls: str
    s0: int
    max_new: int
    tokens: np.ndarray
    arrival: float
    t_enqueue: float
    t_admit: float
    t_first: float
    t_done: float
    ttft: float                 # first token latency incl. queueing

    @property
    def n_tokens(self) -> int:
        return int(self.tokens.shape[0])

    @property
    def per_token_s(self) -> float:
        """Mean inter-token latency after the first token."""
        if self.n_tokens <= 1:
            return 0.0
        return (self.t_done - self.t_first) / (self.n_tokens - 1)


class ServeEngine:
    """Fixed-shape continuous-batching engine around one TransformerLM.

    Args:
      max_batch: decode batch slots.
      max_len: logical context bound: every request must satisfy
        ``s0 + max_new - 1 <= max_len`` when the arch has full-attention
        layers (sliding-window and recurrent layers are rings and states).
      page_size: tokens per KV page.
      num_pages: pages per kind {"attn": n, "swa": n}; by default each pool
        holds ``max_batch`` full-length requests (never blocks).
      quantized: int8 KV pool (blockwise scales) instead of float32.
      eos: token id that ends a slot (-1 = never).
      seed: the sampling generator's seed.
      sink: the telemetry stream (a fresh in-memory one when None).
      log_every: a ``serve`` record every this many decode steps.

    The engine runs on the parameters' device.
    """

    def __init__(self, model: TransformerLM, params: dict, *, max_batch: int, max_len: int,
                 page_size: int = 8, num_pages: dict | None = None, quantized: bool = False,
                 eos: int = -1, seed: int = 0, sink: MetricsSink | None = None,
                 log_every: int = 64):
        cfg = model.cfg
        if not model.has_prompt_prefill:
            raise ValueError(
                f"ServeEngine needs a token frontend (got {cfg.frontend!r}) "
                "— prefix-frontend archs have no prompt-only prefill")
        self.model = model
        self.params = params
        self.device = next(iter(params.values())).device
        self.max_batch = max_batch
        self.max_len = max_len
        self.page_size = page_size
        self.quantized = quantized
        self.eos = eos
        self.log_every = log_every
        # the engine always has a sink: the lifecycle trace records are the
        # latency accounting even for in-memory runs
        self.sink = sink if sink is not None else MetricsSink()
        self._finished: list[dict] = []  # every finished record: the latency

        blocks = {blk for blk, _ in cfg.head_layers()} | {blk for blk, _ in cfg.group_pattern()}
        self.kinds = sorted(blocks & {"attn", "swa"})
        self.ring_len = {k: paged_kv_len(cfg, k, max_len) for k in self.kinds}
        self.n_blocks = {k: -(-t // page_size) for k, t in self.ring_len.items()}
        if num_pages is None:
            num_pages = {k: 1 + max_batch * nb for k, nb in self.n_blocks.items()}
        self.num_pages = {k: num_pages[k] for k in self.kinds}
        self.sched = Scheduler(max_batch, page_size, self.num_pages, self.ring_len)

        b, dev = max_batch, self.device
        self._carry = {
            "cache": model.init_paged_cache(b, self.num_pages, page_size, quantized=quantized,
                                            device=dev),
            "tok": torch.zeros((b, 1), dtype=torch.int64, device=dev),
            "pos": torch.zeros((b,), dtype=torch.int64, device=dev),
            "active": torch.zeros((b,), dtype=torch.bool, device=dev),
            "limit": torch.zeros((b,), dtype=torch.int64, device=dev),
            "temp": torch.zeros((b,), dtype=torch.float32, device=dev),
        }
        self._gen = torch.Generator(device=dev).manual_seed(seed)
        self._tables = {k: torch.full((b, nb), TRASH_PAGE, dtype=torch.int64, device=dev)
                        for k, nb in self.n_blocks.items()}
        self._active_np = np.zeros((b,), bool)

        self._slot_tokens: list[list[int]] = [[] for _ in range(b)]
        self._slot_meta: list[dict | None] = [None] * b
        self._steps = 0
        self._admitted = 0
        self._completed = 0
        # the first call of each program (kernel build and load, allocator
        # warm-up) is charged apart from steady state, as the reference
        # charges its compiles
        self._decode_first = True
        self._decode_compile_s = 0.0
        self._decode_steady_s = 0.0
        self._steady_tokens = 0
        self._steady_steps = 0
        self._prefill_seen: set[int] = set()
        self._prefill_compile_s = 0.0
        self._prefill_steady_s = 0.0
        self._prefill_tokens = 0

    # -- the step -------------------------------------------------------------

    @torch.inference_mode()
    def _step(self) -> torch.Tensor:
        """One decode step over every slot; advances the carry on the device
        and returns the (2, B) output (tokens, -1 where inactive; the next
        active mask) on the device."""
        c = self._carry
        pos, active = c["pos"], c["active"]
        with scope("obs:serve/decode"):
            logits, _ = self.model.paged_decode_step(self.params, c["tok"], pos, c["cache"],
                                                     self._tables, max_len=self.max_len)
        with scope("obs:serve/sample"):
            nxt = sample_tokens(logits, self._gen, c["temp"])
        done = (nxt == self.eos) | (pos >= c["limit"])
        still = active & ~done
        out = torch.stack([torch.where(active, nxt, -1), still.long()])
        c["tok"] = torch.where(active, nxt, c["tok"][:, 0])[:, None]
        c["pos"] = torch.where(active, pos + 1, pos)
        c["active"] = still
        return out

    # -- admission ------------------------------------------------------------

    @torch.inference_mode()
    def _admit(self, adm: Admission, now: float) -> None:
        req, slot = adm.req, adm.slot
        s0 = req.s0
        rows = {}
        for kind, table in self._tables.items():
            row = np.full((self.n_blocks[kind],), TRASH_PAGE, np.int64)
            pages = adm.pages[kind]
            row[:len(pages)] = pages
            rows[kind] = torch.from_numpy(row).to(self.device)
            table[slot] = rows[kind]
        c = self._carry
        t0 = time.monotonic()
        if s0 == 1:
            # nothing to prefill, but the slot's recurrent rows still hold
            # the previous request's state
            clear_slot_state(self.model, c["cache"], slot)
        else:
            prompt = torch.from_numpy(req.prompt[None, :s0 - 1].astype(np.int64)).to(self.device)
            with scope("obs:serve/prefill"):
                _, pf = self.model.prefill(self.params, {"tokens": prompt})
                place_paged_prefill(self.model, pf, c["cache"], rows, slot, s0, self.max_len)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        dt = time.monotonic() - t0
        if s0 in self._prefill_seen or s0 == 1:
            self._prefill_steady_s += dt
            self._prefill_tokens += s0 - 1
        else:
            self._prefill_seen.add(s0)
            self._prefill_compile_s += dt

        # the shared decode step produces the request's FIRST token: its
        # input is the last prompt token at position s0 - 1, so TTFT is the
        # latency of the slot's first decode step
        c["tok"][slot, 0] = int(req.prompt[s0 - 1])
        c["pos"][slot] = s0 - 1
        c["active"][slot] = True
        c["limit"][slot] = s0 + req.max_new - 2
        c["temp"][slot] = req.temperature
        self._active_np[slot] = True
        self._slot_tokens[slot] = []
        pages_total = sum(len(p) for p in adm.pages.values())
        self._slot_meta[slot] = dict(req=req, t_admit=now, t_first=None, pages=pages_total)
        self._admitted += 1
        self._trace("admitted", rid=req.rid, cls=req.cls, slot=slot, pages=pages_total,
                    t_s=now)
        self._trace("prefill", rid=req.rid, slot=slot, tokens=s0 - 1, dur_s=dt, t_s=now + dt)

    # -- the decode step on the host's side -------------------------------------

    def _decode_once(self, completions: list, t0: float, clock: str, enqueue_t: dict) -> None:
        was_active = np.nonzero(self._active_np)[0]
        ts = time.monotonic()
        out = self._step().cpu().numpy()  # the per-step device-to-host copy
        dt = time.monotonic() - ts
        now = time.monotonic() - t0
        if self._decode_first:
            self._decode_first = False
            self._decode_compile_s += dt
        else:
            self._decode_steady_s += dt
            self._steady_tokens += len(was_active)
            self._steady_steps += 1

        toks, still = out[0], out[1].astype(bool)
        for slot in was_active:
            self._slot_tokens[slot].append(int(toks[slot]))
            meta = self._slot_meta[slot]
            if meta["t_first"] is None:
                meta["t_first"] = now
                mreq = meta["req"]
                ref = mreq.arrival if clock == "wall" else enqueue_t[mreq.rid]
                self._trace("first_token", rid=mreq.rid, cls=mreq.cls, slot=int(slot), t_s=now,
                            ttft_s=now - ref)
            if not still[slot]:
                self._active_np[slot] = False
                self._tables_clear(slot)
                req = self.sched.release(slot)
                t_enq = enqueue_t[req.rid]
                ref = req.arrival if clock == "wall" else t_enq
                comp = Completion(
                    rid=req.rid, cls=req.cls, s0=req.s0, max_new=req.max_new,
                    tokens=np.asarray(self._slot_tokens[slot], np.int32),
                    arrival=req.arrival, t_enqueue=t_enq, t_admit=meta["t_admit"],
                    t_first=meta["t_first"], t_done=now, ttft=meta["t_first"] - ref)
                completions.append(comp)
                self._trace("finished", rid=req.rid, cls=req.cls, slot=int(slot), s0=req.s0,
                            tokens=comp.n_tokens, pages=meta["pages"],
                            queued_s=meta["t_admit"] - t_enq, ttft_s=comp.ttft,
                            per_token_s=comp.per_token_s, t_s=now, dur_s=now - meta["t_admit"])
                self._slot_meta[slot] = None
                self._completed += 1
        self._steps += 1
        if self._steps % self.log_every == 0:
            self._log_serve(step_ms=dt * 1e3)

    def _tables_clear(self, slot: int) -> None:
        # a freed slot writes to the trash page again: its pages are about
        # to be handed to the next admission
        for table in self._tables.values():
            table[slot] = TRASH_PAGE

    # -- driving --------------------------------------------------------------

    def run(self, trace: list[Request], *, clock: str = "wall",
            max_steps: int | None = None) -> dict:
        """Drain one open-loop trace; returns the run report.

        ``clock="wall"``: arrivals are seconds of wall time from run start.
        ``clock="steps"``: arrivals are decode-step indices — deterministic,
        for tests and smoke runs.
        """
        if clock not in ("wall", "steps"):
            raise ValueError(f"clock must be 'wall'|'steps', got {clock!r}")
        order = sorted(trace, key=lambda r: (r.arrival, r.rid))
        completions: list[Completion] = []
        enqueue_t: dict[int, float] = {}
        t0 = time.monotonic()
        i = 0
        while True:
            now = (time.monotonic() - t0) if clock == "wall" else float(self._steps)
            while i < len(order) and order[i].arrival <= now:
                self.sched.submit(order[i])
                t_enq = time.monotonic() - t0
                enqueue_t[order[i].rid] = t_enq
                self._trace("queued", rid=order[i].rid, cls=order[i].cls, t_s=t_enq)
                i += 1
            while True:
                adm = self.sched.next_admission()
                if adm is None:
                    break
                self._admit(adm, time.monotonic() - t0)
            if self.sched.active_slots == 0:
                if i == len(order) and not self.sched.waiting:
                    break
                if clock == "wall":
                    time.sleep(min(1e-3, max(0.0, order[i].arrival - now)))
                else:
                    self._steps += 1    # an idle step advances virtual time
                continue
            self._decode_once(completions, t0, clock, enqueue_t)
            if max_steps is not None and self._steps >= max_steps:
                break
        report = self.report(completions, time.monotonic() - t0)
        self._log_serve(step_ms=None)
        return report

    # -- reporting ------------------------------------------------------------

    @property
    def records(self) -> list[dict]:
        """The sink's records (its ring buffer)."""
        return self.sink.records()

    def report(self, completions: list[Completion], wall_s: float) -> dict:
        """The reference's run report without ``programs``: completions,
        latency (from the ``finished`` trace records), steps, wall seconds,
        admitted, completed, and decode / prefill first-call and steady
        seconds, tokens and rates."""
        prefill_tok_s = (self._prefill_tokens / self._prefill_steady_s
                         if self._prefill_steady_s > 0 else 0.0)
        return {
            "completions": completions,
            "latency": serve_latency_summary(self._finished),
            "steps": self._steps,
            "wall_s": wall_s,
            "admitted": self._admitted,
            "completed": self._completed,
            "decode": {
                "compile_s": self._decode_compile_s,
                "steady_s": self._decode_steady_s,
                "steady_steps": self._steady_steps,
                "steady_tokens": self._steady_tokens,
                "tok_s": self._decode_tok_s(),
            },
            "prefill": {
                "compile_s": self._prefill_compile_s,
                "steady_s": self._prefill_steady_s,
                "tokens": self._prefill_tokens,
                "tok_s": prefill_tok_s,
            },
        }

    def _trace(self, event: str, **fields) -> None:
        """One lifecycle trace record; ``step`` is the decode-step index."""
        rec = self.sink.log("trace", self._steps, event=event, **fields)
        if event == "finished":
            self._finished.append(rec)

    def _decode_tok_s(self) -> float:
        return (self._steady_tokens / self._decode_steady_s
                if self._decode_steady_s > 0 else 0.0)

    def _log_serve(self, step_ms: float | None) -> None:
        self.sink.log("serve", self._steps, active_slots=self.sched.active_slots,
                      queued=self.sched.queued, kv_occupancy=self.sched.occupancy(),
                      kv_pages_used=self.sched.pages_used(),
                      kv_pages_total=self.sched.pages_total(), admitted=self._admitted,
                      completed=self._completed, decode_tok_s=self._decode_tok_s(),
                      step_ms=step_ms)
