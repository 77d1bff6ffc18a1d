"""The trainer's captured step: the DR-DSGD step replayed from CUDA graphs
(the port of the reference's ``jax.jit`` of its step and its
``jax.lax.scan`` over the steps with the carry donated,
``repro/core/api.py``).

Where :func:`~repro_torch.core.drdsgd.capture_declined` keeps the stack
(any optimizer with a device form, any of the port's mixers — static or
time-varying, faulted, dense, gossip or hub, any wire, under
``LocalUpdateMixer`` or ``RepeatMixer``, every step or every
``mix_every``-th — no telemetry tap, no sanitizer, no noise hook),
:class:`CapturedRun` runs the step's capturable form
(``train_step.capturable``: the fused B.1 step where it applies, else the
optimizer and the mixer's round) from one CUDA graph per program on the
card, and the same form eagerly on the CPU, so the CPU tests hold the code
the card captures.

* **One slot, updated in place.**  The slot holds the carry's tensors: the
  node-stacked parameters, the optimizer state (``MomentumState``,
  ``AdamState``) and every tensor of the ``CommState`` (θ̂ and the mix cache
  ``hat`` and ``hat_mix`` leaf by leaf).  The graph reads the slot and the
  form writes the new parameters, the optimizer state and the dense codec
  round's θ̂ back into it (``inplace=True``: B.1's ``out`` is θ, each of its
  threads reading every node's column before it writes that column; the
  optimizers and the codec rounds run the eager step's operations into the
  given tensors); what a form makes out of place (the gossip round's θ̂ and
  mix cache, the ``CommState``'s scalars) is computed in the graph's pool
  and copied into the slot.  The gradients, the activations and the round's
  buffers live in the graph's pool.  So the step holds no more than the
  eager step, which keeps the old state beside the new one until it
  returns.
* **The carry is donated.**  On the card the state a run returns holds
  the slot, and the next run writes over it, as a donated JAX buffer is
  consumed.  A state the trainer did not return (the first one, a
  restored one) gives up its parameters, optimizer state and θ̂: the first
  step runs in place on them (where each lies contiguous in a storage of
  its own) and they become the slot, so that step holds no more than a
  captured one; a tensor that step makes anew takes its old one's place,
  whose storage is freed, as are a later state's once it is copied into
  the slot.  So a caller that keeps the state's name holds no extra copy.
  Passing a state whose tensors were freed, or a state that holds the slot
  but is not the one the trainer returned last (its ``step`` or host
  counters are behind the slot's), raises.  On the CPU the state is copied
  in and the result copied out, as JAX ignores donation on its CPU backend.
* **Inputs.**  One byte buffer per program holds a step's inputs: its
  head holds the metrics column and the round (int64) and η, Adam's
  ``bc1`` and ``bc2`` and the rate schedule's host part (float32): the
  form's :class:`~repro_torch.core.drdsgd.StepScalars`, read on the card
  (B.1 reads η, B.2 a schedule's rate and the Philox kernel the round
  through pointers); the batch leaves follow, each at a 512-byte offset.
  A run packs its steps' inputs on the device, :data:`PACK_STEPS` at a
  time (the head's values, from ``train_step.host_scalars``, in one
  host-to-device copy each time), then each step costs one device copy
  into the buffer and the replay, and never waits for the device.
* **Metrics.**  Each replay writes the step's metrics into one column of a
  (metrics, :data:`METRIC_COLS`) float32 device buffer; a run copies the
  columns out every :data:`METRIC_COLS` steps and at its end.
* **Branches and host fields.**  ``train_step.host_branch`` gives each
  step's branch (whether it mixes, each wrapper's consensus test, each
  clocked EF round's re-base: what the reference decides with
  ``lax.cond``) and the ``CommState``'s host ints after it (``rounds``,
  ``ef_rounds``), from the step and the host ints before it.  A run walks
  it step by step: each step replays its own branch's graph, and its
  inputs are packed at its own step and round.
* **Warm-up.**  The first step of each program runs eagerly (the same
  form: the first program's new state becomes the slot, a later program's
  updates the slot in place; a branch met late, in the middle of a run or
  after a restore, is warmed up where it first appears), and the host
  ints it advanced are held against the host function's (a mismatch
  raises), on the stream the capture then uses, as
  PyTorch's graph capture asks: it builds the kernels and makes every
  first-use CUDA call (the tensor-map encoder's lookup, the kernels'
  attributes, cuBLAS's handle and workspace) before the capture.
  ``torch.cuda.graph`` then gives the cache's free blocks back to the
  device, so the graph's pool can take the memory the warm-up's gradients
  and activations held.
* **Launch counters.**  A replay runs no Python, so each graph keeps the
  counter increments its capture made (:func:`repro_torch.kernels.
  launch_counters`), takes them back (a capture launches nothing) and adds
  them on every replay.
* **Programs.**  One program per (batch signature, branch): the branch
  graphs of a signature share its input buffer and layout, and every graph
  captures into one pool, one after another, so the pool holds the
  largest graph's buffers, not their sum.  Graphs replay in an order other
  than their capture order, which is safe because nothing a graph
  allocates outlives its replay: the slot, the input buffers and the
  metrics buffer lie outside the pool.  A program met after others were
  captured first releases them and their pool (one synchronisation), so
  that its eager warm-up runs in the memory the pool held, as the first
  warm-up did; then every program is captured again.  ``programs`` counts
  the graphs (the watchdog's ``_cache_size``), and each capture (a
  recapture too) is published to
  :func:`repro_torch.obs.watchdog.record_capture`.

No failure falls back to the eager step: a warm-up, capture or replay
that fails raises.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from repro_torch.comm.protocol import CommState
from repro_torch.core.drdsgd import DecentralizedState, StepScalars, step_scalars
from repro_torch.kernels import launch_counters
from repro_torch.obs import watchdog

ALIGN = 512          # byte offset of every input leaf (the allocator's alignment)
METRIC_COLS = 1024   # steps whose metrics the device buffer holds
PACK_STEPS = 64      # steps whose inputs a run packs at a time
# byte offsets in the input buffer's head: the metrics column and the round
# (int64), η, bc1, bc2 and the schedule's host part (float32)
_COL, _ROUND, _ETA, _BC1, _BC2, _PART = 0, 8, 16, 20, 24, 28
_HEAD = 32


def _walk(path: str, tree, fn):
    """``tree`` with each tensor t at ``path`` replaced by ``fn(path, t)``:
    dicts by key, tuples by position (so a restored optimizer state, a plain
    tuple, has its typed state's paths), anything else kept."""
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _walk(f"{path}/{k}", v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [_walk(f"{path}/{i}", v, fn) for i, v in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def _tensors(state: DecentralizedState) -> dict:
    """The carry's tensors by path: the parameters, the optimizer state and
    the ``CommState``'s tensor fields (a dict field leaf by leaf)."""
    out = {}

    def take(path, t):
        out[path] = t
        return t

    for name in ("params", "opt_state", "comm"):
        _walk(name, getattr(state, name), take)
    return out


def _rebuild(state: DecentralizedState, flat: dict) -> DecentralizedState:
    """``state`` with every tensor of its carry replaced by ``flat``'s at
    its path."""
    return state._replace(**{name: _walk(name, getattr(state, name), lambda p, _: flat[p])
                             for name in ("params", "opt_state", "comm")})


def _host_ints(comm) -> tuple:
    """The ``CommState``'s host-int fields, (name, value) in field order."""
    return tuple((f, getattr(comm, f)) for f in CommState._fields
                 if type(getattr(comm, f)) is int)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _exclusive(tensors) -> bool:
    """Each tensor contiguous and in a storage of its own: a step may write
    into them in place."""
    ptrs = {_storage(t) for t in tensors}
    return len(ptrs) == len(tensors) and all(t.is_contiguous() for t in tensors)


class _Program:
    """The step at one batch signature: its input buffer, and one captured
    graph per branch."""

    def __init__(self, shapes, device):
        self.layout, off = [], ALIGN
        for shape, dtype in shapes:
            n = int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
            self.layout.append((off, n, shape, dtype))
            off += -(-n // ALIGN) * ALIGN
        self.inbuf = torch.zeros(off, dtype=torch.uint8, device=device)
        self.batch = tuple(self.inbuf[o:o + n].view(dtype).view(shape)
                           for o, n, shape, dtype in self.layout)
        self.col = self.inbuf[_COL:_COL + 8].view(torch.int64)

        def f32(o):
            return self.inbuf[o:o + 4].view(torch.float32)[0]

        self.scalars = StepScalars(eta=f32(_ETA), bc1=f32(_BC1), bc2=f32(_BC2),
                                   round=self.inbuf[_ROUND:_ROUND + 8].view(torch.int64)[0],
                                   part=f32(_PART))
        # branch -> (the captured step on the card, else None; [(wrapper,
        # attribute, increment)] per replay), or None while to be captured
        self.graphs: dict = {}


class CapturedRun:
    """The captured step of a :class:`~repro_torch.core.DecentralizedTrainer`
    (``jit=True`` on a stack :func:`~repro_torch.core.drdsgd.capture_declined`
    keeps): :meth:`segment` runs steps ``lo..hi-1`` of stacked batches;
    ``_cache_size()`` is the programs (graphs) captured."""

    def __init__(self, train_step, device: torch.device):
        self._form = train_step.capturable
        self._scalars = train_step.host_scalars
        self._branch = train_step.host_branch
        self.device = device
        self._card = device.type == "cuda"
        self._programs: dict = {}
        self._slot = None       # {path: tensor} of the carry (see _tensors)
        self._at = None         # (step, host ints) of the state the slot holds
        self._comm = None       # a CommState for the body's host fields
        self._keys = None       # the metrics' names, in order
        self._mbuf = None       # (metrics, METRIC_COLS) float32
        self._template = None   # a state of the carry's structure
        self._pool = None
        self._stream = torch.cuda.Stream(device) if self._card else None

    @property
    def programs(self) -> int:
        return sum(len(prog.graphs) for prog in self._programs.values())

    def _cache_size(self) -> int:
        return self.programs

    # -- the state ---------------------------------------------------------------

    @staticmethod
    def _carry(state: DecentralizedState) -> dict:
        """The carry's tensors (:func:`_tensors`); raises where the state's
        ``comm`` is not a ``CommState``."""
        if not isinstance(state.comm, CommState):
            raise ValueError("DecentralizedState.comm must be the mixer's CommState")
        return _tensors(state)

    @staticmethod
    def _stamp(state: DecentralizedState) -> tuple:
        return state.step, _host_ints(state.comm)

    def _held(self, state: DecentralizedState) -> bool:
        """Whether ``state`` holds the slot.  Raises where its donated
        tensors (every tensor of the carry but the ``CommState``'s scalars)
        were given up, or where it holds the slot (or part of it) but is not
        the state the slot holds now: one returned before later steps wrote
        over the slot."""
        donated = {p: t for p, t in self._carry(state).items() if t.ndim}
        if any(t.numel() and t.untyped_storage().nbytes() == 0 for t in donated.values()):
            raise RuntimeError("this state's tensors were donated to a step of the captured "
                               "run and freed: pass the state the trainer returned last")
        if self._slot is None:
            return False
        mine = [t is self._slot.get(p) for p, t in donated.items()]
        if not any(mine):
            return False
        slot = {p for p, t in self._slot.items() if t.ndim}
        if not all(mine) or set(donated) != slot or self._stamp(state) != self._at:
            raise RuntimeError(f"this state's tensors were donated to the captured run and "
                               f"written over (it is at step {state.step}, the run at step "
                               f"{self._at[0]}): pass the state the trainer returned last")
        return True

    def _give_up(self, tensors) -> None:
        """Donation on the card: free the storage of each of ``tensors`` that
        the slot does not hold (a state the caller handed over), as a
        donated JAX buffer is deleted; the CPU keeps them (JAX ignores
        donation there)."""
        if not self._card:
            return
        held = {_storage(t) for t in self._slot.values()}
        for t in tensors:
            if _storage(t) not in held:
                t.untyped_storage().resize_(0)

    def _take(self, state: DecentralizedState) -> None:
        """Put ``state`` into the slot: copied in unless it holds the slot."""
        flat = self._carry(state)
        if set(flat) != set(self._slot):
            raise ValueError(f"the captured step carries {sorted(self._slot)}, got "
                             f"{sorted(flat)}")
        for p, t in flat.items():
            s = self._slot[p]
            if t.shape != s.shape or t.dtype != s.dtype:
                raise ValueError(f"{p}: the captured step holds {tuple(s.shape)} {s.dtype}, "
                                 f"got {tuple(t.shape)} {t.dtype}")
        held = self._held(state)
        for p, t in flat.items():
            if t is not self._slot[p]:
                self._slot[p].copy_(t)
        if not held:
            self._give_up([t for t in flat.values() if t.ndim])
        self._comm = state.comm
        self._at = self._stamp(state)

    def _state(self, step: int, comm) -> DecentralizedState:
        """The state the slot holds, at ``step`` with ``comm``'s host ints
        (copies of the slot on the CPU)."""
        flat = self._slot if self._card else {p: t.clone() for p, t in self._slot.items()}
        new = _rebuild(self._template._replace(step=step, comm=comm), flat)
        self._comm, self._at = new.comm, self._stamp(new)
        return new

    def _slot_state(self, step: int | None = None, comm=None) -> DecentralizedState:
        """The state the slot holds, at ``step`` with ``comm``'s host ints
        (default: those of the last one)."""
        step = self._at[0] if step is None else step
        return _rebuild(self._template._replace(step=step, comm=self._comm if comm is None
                                                else comm), self._slot)

    def _copy_in(self, new: DecentralizedState) -> None:
        """The step's new carry tensors into the slot's (those the form did
        not write in place)."""
        for p, t in _tensors(new).items():
            if t is not self._slot[p]:
                self._slot[p].copy_(t)

    @staticmethod
    def _own(flat: dict, given) -> dict:
        """The first step's new carry as the slot: each tensor whose storage
        another carry tensor or a tensor of the given state holds (a field
        the round passed through) cloned, so that the slot's tensors share
        nothing."""
        seen = {_storage(t) for t in given}
        out = {}
        for p, t in flat.items():
            if _storage(t) in seen:
                t = t.clone()
            seen.add(_storage(t))
            out[p] = t
        return out

    # -- warm-up and capture -----------------------------------------------------

    def _warm_up(self, state, batch, branch, after):
        """One eager step of ``branch`` (on the capture's stream on the
        card), the form the graph captures.  The first program's step runs
        in place on the given state on the card (its tensors donated; out of
        place where two share a storage, and on the CPU, where the caller's
        state is left as it is), and its new state becomes the slot; a
        later program's step runs on the slot and updates it in place.  The
        host ints it advanced must be ``after``'s (the host function's).
        The metrics must be 0-d float32 tensors, as the captured step stacks
        them."""
        if self._slot is None:
            self._held(state)  # a freed state raises
            given = list(self._carry(state).values())
            inplace = self._card and _exclusive([t for t in given if t.ndim])
            if inplace:  # the donated tensors become the slot as they are
                given = [t for t in given if not t.ndim]
        else:
            given, inplace = [], True
        sc = step_scalars(self._scalars(state.step, state.comm.rounds), self.device)
        if self._card:
            main = torch.cuda.current_stream(self.device)
            self._stream.wait_stream(main)
            with torch.cuda.stream(self._stream):
                new, m = self._form(state, batch, sc, inplace=inplace, branch=branch)
            main.wait_stream(self._stream)
            # allocated on the capture's stream, used on the caller's from here
            for t in (*_tensors(new).values(), *m.values()):
                t.record_stream(main)
        else:
            new, m = self._form(state, batch, sc, inplace=inplace, branch=branch)
        want = (state.step + 1, _host_ints(after))
        if self._stamp(new) != want:
            raise RuntimeError(f"the step of branch {branch} advanced the host fields to "
                               f"{self._stamp(new)}, the host function to {want}")
        if self._slot is None:
            self._slot = self._own(self._carry(new), given)
            self._template = new
            # the step's input, consumed: what the slot does not hold is freed
            self._give_up([t for t in self._carry(state).values() if t.ndim])
        else:
            self._copy_in(new)
        state = _rebuild(new, self._slot)
        self._comm, self._at = state.comm, self._stamp(state)
        bad = {k: (tuple(v.shape), v.dtype) for k, v in m.items()
               if not (isinstance(v, torch.Tensor) and v.ndim == 0 and v.dtype == torch.float32)}
        if bad:
            raise ValueError(f"the captured step stacks 0-d float32 metrics, got {bad}")
        if self._keys is None:
            self._keys = list(m)
            self._mbuf = torch.zeros((len(self._keys), METRIC_COLS), dtype=torch.float32,
                                     device=self.device)
        return state, m

    def _body(self, prog: _Program, branch) -> None:
        """The step of ``branch`` from the slot into the slot, its metrics
        into the buffer's column ``prog.col``: what the graph captures."""
        new, m = self._form(self._slot_state(), prog.batch, prog.scalars, inplace=True,
                            branch=branch)
        self._copy_in(new)
        self._mbuf.index_copy_(1, prog.col, torch.stack([m[k] for k in self._keys])[:, None])

    def _release(self) -> None:
        """Drop every captured graph and their pool (on the card, once one
        exists), to be captured again by :meth:`_capture_all`: a warm-up
        then has the memory the pool held.  Waits for the replays in
        flight."""
        if self._pool is None:
            return
        torch.cuda.synchronize(self.device)
        for prog in self._programs.values():
            for branch in prog.graphs:
                prog.graphs[branch] = None
        self._pool = None
        gc.collect()
        torch.cuda.empty_cache()

    def _capture_all(self) -> None:
        """Capture every program that has no graph."""
        for prog in self._programs.values():
            for branch, graph in prog.graphs.items():
                if graph is None:
                    self._capture(prog, branch)

    def _capture(self, prog: _Program, branch) -> None:
        """The graph of ``branch`` at ``prog``'s signature on the card, with
        the counter increments its capture made; nothing to capture on the
        CPU, where :meth:`_replay` runs the same body eagerly."""
        graph, deltas = None, []
        if self._card:
            counters = launch_counters()
            before = [getattr(fn, a) for fn, a in counters]
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
                self._body(prog, branch)
            if self._pool is None:
                self._pool = graph.pool()
            deltas = [(fn, a, getattr(fn, a) - v) for (fn, a), v in zip(counters, before)
                      if getattr(fn, a) != v]
            for (fn, a), v in zip(counters, before):  # a capture launches nothing
                setattr(fn, a, v)
        prog.graphs[branch] = (graph, deltas)
        watchdog.record_capture("train_step")

    # -- replays -----------------------------------------------------------------

    def _pack(self, prog: _Program, batches, steps: list, n0: int) -> torch.Tensor:
        """The inputs of ``steps`` ([(batch index, step, round, branch)], at
        consecutive batch indices), one row of ``prog.inbuf``'s bytes each;
        the first is the ``n0``-th replay since the metrics were read."""
        n, lo = len(steps), steps[0][0]
        packed = torch.empty((n, prog.inbuf.numel()), dtype=torch.uint8, device=self.device)
        for (off, nb, _, _), b in zip(prog.layout, batches):
            packed[:, off:off + nb].copy_(b[lo:lo + n].reshape(n, -1).view(torch.uint8))
        vals = [self._scalars(step, rounds) for _, step, rounds, _ in steps]
        head = np.zeros((n, _HEAD), dtype=np.uint8)
        head[:, _COL:_COL + 8] = ((n0 + np.arange(n, dtype=np.int64)) % METRIC_COLS
                                  )[:, None].view(np.uint8)
        head[:, _ROUND:_ROUND + 8] = np.array([v[3] for v in vals], dtype=np.int64
                                              )[:, None].view(np.uint8)
        head[:, _ETA:_PART + 4] = np.array([(v[0], v[1], v[2], v[4]) for v in vals],
                                           dtype=np.float32).view(np.uint8)
        head_t = torch.from_numpy(head)
        if self._card:
            head_t = head_t.pin_memory().to(self.device, non_blocking=True)
        packed[:, :_HEAD].copy_(head_t)
        return packed

    def _replay(self, prog: _Program, branch) -> None:
        graph, deltas = prog.graphs[branch]
        if graph is None:
            self._body(prog, branch)
            return
        graph.replay()
        for fn, a, d in deltas:
            setattr(fn, a, getattr(fn, a) + d)

    def _flush(self, prog: _Program, batches, pending: list, parts: list) -> None:
        """Replay ``pending`` (consecutive steps, each with its branch's
        graph), their inputs packed :data:`PACK_STEPS` at a time, and append
        their metrics' columns to ``parts``."""
        for c0 in range(0, len(pending), PACK_STEPS):
            chunk = pending[c0:c0 + PACK_STEPS]
            packed = self._pack(prog, batches, chunk, c0)
            for j, (_, _, _, branch) in enumerate(chunk):
                prog.inbuf.copy_(packed[j])
                self._replay(prog, branch)
                n = c0 + j
                if n % METRIC_COLS == METRIC_COLS - 1 or n == len(pending) - 1:
                    parts.append(self._mbuf[:, :n % METRIC_COLS + 1].clone())

    def segment(self, state: DecentralizedState, batches, lo: int, hi: int):
        """Steps ``lo..hi-1`` of ``batches`` (every leaf (T, ...) on the
        trainer's device) from ``state``; returns (state, metrics), every
        metric stacked to (hi - lo,).  Each step's branch and host ints come
        from the host function; a step whose (signature, branch) has a
        graph replays it, any other is warmed up there and captured."""
        sig = tuple((tuple(b.shape[1:]), b.dtype) for b in batches)
        prog = self._programs.get(sig)
        if self._slot is not None:
            self._take(state)
        step, comm = state.step, state.comm
        parts, pending = [], []
        for i in range(lo, hi):
            branch, after = self._branch(step, comm)
            if prog is not None and branch in prog.graphs:
                pending.append((i, step, comm.rounds, branch))
            else:  # this (signature, branch)'s first step, eager: the warm-up
                self._flush(prog, batches, pending, parts)
                pending = []
                self._release()
                if self._slot is not None:
                    state = self._slot_state(step, comm)
                state, m = self._warm_up(state, tuple(b[i] for b in batches), branch, after)
                parts.append(torch.stack([m[k] for k in self._keys])[:, None])
                if prog is None:
                    prog = self._programs[sig] = _Program(sig, self.device)
                prog.graphs[branch] = None
                self._capture_all()
            step, comm = step + 1, after
        self._flush(prog, batches, pending, parts)
        state = self._state(step, comm)
        ms = torch.cat(parts, 1)
        return state, {k: ms[j] for j, k in enumerate(self._keys)}
