"""The trainer's captured step: the fused DR-DSGD step replayed from CUDA
graphs (the port of the reference's ``jax.jit`` of its step and its
``jax.lax.scan`` over the steps with the carry donated,
``repro/core/api.py``).

Where :func:`~repro_torch.core.drdsgd.capture_declined` keeps the stack
(plain SGD, a static uncompressed dense W, a round on every step, no
telemetry tap, no sanitizer), :class:`CapturedRun` runs the fused step
(``train_step.fused``: the gradients, the robust scale and one B.1 launch
per 16 leaves) from one CUDA graph per program on the card, and the same capturable
form eagerly on the CPU, so the CPU tests hold the code the card captures.

* **One slot, updated in place.**  The slot is a node-stacked copy of the
  parameters with the ``CommState``'s tensors beside it.  The graph reads
  the slot, and B.1 writes the new parameters back into it (its ``out``
  is θ: each of its threads reads every node's column before it writes
  that column).  The gradients and the activations live in the graph's
  pool.  The step so holds the parameters and their gradients, with the
  activations during the backward: no more than the eager step, which
  allocates its new parameters after the backward (three node-stacked
  copies at its peak).
* **The carry is donated.**  On the card the state a run returns holds
  the slot, and the next run writes over it, as a donated JAX buffer is
  consumed.  A state the trainer did not return (the first one, a
  restored one) gives up its parameters: the first step's input once that
  step has read it, a later one once it is copied into the slot, their
  storages freed, so a caller that keeps its name holds no extra copy.
  The first step's new parameters become the slot.  Passing a state whose
  parameters were freed, or a state that holds the slot but is not the
  one the trainer returned last (its ``step`` or host counters are
  behind the slot's), raises.  On the CPU the state is copied in and the
  result copied out, as JAX ignores donation on its CPU backend.
* **Inputs.**  One byte buffer per program holds a step's inputs: the
  metrics column (int64), η (float32, read by B.1 through a pointer) and
  the batch leaves, each at a 512-byte offset.  A run packs its steps'
  inputs on the device, :data:`PACK_STEPS` at a time (the η and column
  values in one host-to-device copy each time), then each step costs one
  device copy into the buffer and the replay, and never waits for the
  device.
* **Metrics.**  Each replay writes the step's metrics into one column of a
  (metrics, :data:`METRIC_COLS`) float32 device buffer; a run copies the
  columns out every :data:`METRIC_COLS` steps and at its end.
* **Host fields.**  ``step`` and the ``CommState``'s host ints
  (``rounds``) advance on every replay by what the captured step advanced
  them by.
* **Warm-up.**  The first step of each program runs eagerly (the same
  fused step: the first program's new parameters become the slot, a later
  program's update the slot in place), on the stream the capture then
  uses, as PyTorch's graph capture asks: it builds the kernels and makes
  every first-use CUDA call (the tensor-map encoder's lookup, the kernels'
  attributes, cuBLAS's handle and workspace) before the capture.
  ``torch.cuda.graph`` then gives the cache's free blocks back to the
  device, so the graph's pool can take the memory the warm-up's gradients
  and activations held.
* **Launch counters.**  A replay runs no Python, so each graph keeps the
  counter increments its capture made (:func:`repro_torch.kernels.
  launch_counters`), takes them back (a capture launches nothing) and adds
  them on every replay.
* **Programs.**  One program per batch signature (the shapes and dtypes of
  the step's batch leaves); a new signature captures a new pair of graphs
  into the same pool.  ``programs`` counts them (the watchdog's
  ``_cache_size``), and each capture is published to
  :func:`repro_torch.obs.watchdog.record_capture`.

No failure falls back to the eager step: a warm-up, capture or replay
that fails raises.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.comm.protocol import CommState
from repro_torch.core.drdsgd import DecentralizedState
from repro_torch.kernels import launch_counters
from repro_torch.obs import watchdog
from repro_torch.utils.tree import leaf_names

ALIGN = 512          # byte offset of every input leaf (the allocator's alignment)
METRIC_COLS = 1024   # steps whose metrics the device buffer holds
PACK_STEPS = 64      # steps whose inputs a run packs at a time
_COL, _ETA = 0, 8    # byte offsets of the metrics column and of η in the input buffer


class _Program:
    """One captured program: the step at one batch signature."""

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
        self.eta = self.inbuf[_ETA:_ETA + 4].view(torch.float32)[0]
        self.graph = None    # the captured step, on the card
        self.deltas = None   # [(wrapper, attribute, increment)] per replay


class CapturedRun:
    """The captured step of a :class:`~repro_torch.core.DecentralizedTrainer`
    (``jit=True`` on a stack :func:`~repro_torch.core.drdsgd.capture_declined`
    keeps): :meth:`segment` runs steps ``lo..hi-1`` of stacked batches;
    ``_cache_size()`` is the programs captured."""

    def __init__(self, train_step, sgd_lr, device: torch.device):
        self._fused = train_step.fused
        self._lr = sgd_lr
        self.device = device
        self._card = device.type == "cuda"
        self._programs: dict = {}
        self._slot = None       # (params dict, {CommState field: tensor})
        self._at = None         # (step, host ints) of the state the slot holds
        self._comm = None       # a CommState for the body's host fields
        self._keys = None       # the metrics' names, in order
        self._mbuf = None       # (metrics, METRIC_COLS) float32
        self._ints = None       # {CommState host-int field: advance per step}
        self._pool = None
        self._stream = torch.cuda.Stream(device) if self._card else None

    @property
    def programs(self) -> int:
        return len(self._programs)

    def _cache_size(self) -> int:
        return self.programs

    # -- the state ---------------------------------------------------------------

    @staticmethod
    def _comm_tensors(comm) -> dict:
        """The ``CommState``'s tensor fields; raises on a field the captured
        step does not carry (a dict of tensors: an EF wire's copies)."""
        if not isinstance(comm, CommState):
            raise ValueError("DecentralizedState.comm must be the mixer's CommState")
        out = {}
        for f in CommState._fields:
            v = getattr(comm, f)
            if isinstance(v, torch.Tensor):
                out[f] = v
            elif not (isinstance(v, int) or v == ()):
                raise ValueError(f"the captured step carries tensors and host ints in its "
                                 f"CommState; {f} holds a {type(v).__name__}")
        return out

    def _stamp(self, state: DecentralizedState) -> tuple:
        return state.step, tuple(getattr(state.comm, f) for f in self._ints)

    def _held(self, state: DecentralizedState) -> bool:
        """Whether ``state`` holds the slot.  Raises where its parameters
        were given up, or where it holds the slot (or part of it) but is not
        the state the slot holds now: one returned before later steps wrote
        over the slot."""
        if any(x.numel() and x.untyped_storage().nbytes() == 0 for x in state.params.values()):
            raise RuntimeError("this state's parameters were donated to a step of the captured "
                               "run and freed: pass the state the trainer returned last")
        if self._slot is None:
            return False
        params = self._slot[0]
        mine = [x is params.get(n) for n, x in state.params.items()]
        if not any(mine):
            return False
        if not all(mine) or len(mine) != len(params) or self._stamp(state) != self._at:
            raise RuntimeError(f"this state's parameters were donated to the captured run and "
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
        held = {x.untyped_storage().data_ptr() for x in self._slot[0].values()}
        for x in tensors:
            if x.untyped_storage().data_ptr() not in held:
                x.untyped_storage().resize_(0)

    def _take(self, state: DecentralizedState) -> None:
        """Put ``state`` into the slot: copied in unless it holds the slot."""
        if state.opt_state not in ((), None):
            raise ValueError("the captured step is plain SGD, which keeps no optimizer state")
        comm = self._comm_tensors(state.comm)
        params, comm_t = self._slot
        if not self._held(state):
            if leaf_names(state.params) != leaf_names(params):
                raise ValueError(f"the captured step was built for leaves "
                                 f"{leaf_names(params)}, got {leaf_names(state.params)}")
            for n, x in state.params.items():
                if x.shape != params[n].shape or x.dtype != params[n].dtype:
                    raise ValueError(f"{n}: the captured step holds {tuple(params[n].shape)} "
                                     f"{params[n].dtype}, got {tuple(x.shape)} {x.dtype}")
                params[n].copy_(x)
            self._give_up(state.params.values())
        if set(comm) != set(comm_t):
            raise ValueError(f"the captured step carries CommState tensors {sorted(comm_t)}, "
                             f"got {sorted(comm)}")
        for f, t in comm_t.items():
            if comm[f] is not t:
                t.copy_(comm[f])
        self._comm = state.comm
        self._at = self._stamp(state)

    def _state(self, state: DecentralizedState, n: int) -> DecentralizedState:
        """The state after ``n`` replays from ``state``: the slot, the host
        fields advanced (copies of the slot on the CPU)."""
        params, comm_t = self._slot
        if not self._card:
            params = {k: x.clone() for k, x in params.items()}
            comm_t = {f: t.clone() for f, t in comm_t.items()}
        ints = {f: getattr(state.comm, f) + n * d for f, d in self._ints.items()}
        new = DecentralizedState(dict(params), state.opt_state, state.step + n,
                                 state.comm._replace(**comm_t, **ints))
        self._at = self._stamp(new)
        return new

    # -- warm-up and capture -----------------------------------------------------

    def _warm_up(self, state, batch):
        """One eager step (on the capture's stream on the card), the fused
        step as the eager trainer runs it.  The first program's new
        parameters become the slot (B.1 allocates them where the eager step
        does: after the backward, so the step holds no more than the eager
        step's copies); a later program's step runs on the slot and
        updates it in place.  The metrics must be 0-d float32 tensors, as
        the captured step stacks them."""
        before = state.comm
        if self._slot is None:
            self._held(state)  # a freed state raises
            given, out = list(state.params.values()), None
        else:
            self._take(state)
            state = self._slot_state()
            given, out = [], self._slot[0]
        eta = torch.full((), self._lr(state.step), dtype=torch.float32, device=self.device)
        if self._card:
            main = torch.cuda.current_stream(self.device)
            self._stream.wait_stream(main)
            with torch.cuda.stream(self._stream):
                new, m = self._fused(state, batch, eta, out=out)
            main.wait_stream(self._stream)
            # allocated on the capture's stream, used on the caller's from here
            for t in (*new.params.values(), *m.values(),
                      *self._comm_tensors(new.comm).values()):
                t.record_stream(main)
        else:
            new, m = self._fused(state, batch, eta, out=out)
        if self._ints is None:  # the host ints' advance per step
            self._ints = {f: getattr(new.comm, f) - getattr(before, f)
                          for f in CommState._fields if type(getattr(before, f)) is int}
        if self._slot is None:
            self._slot = (dict(new.params), {f: t.clone() for f, t in
                                             self._comm_tensors(new.comm).items()})
            self._give_up(given)  # the step's input, consumed
        else:
            self._copy_comm(new.comm)
        state = new._replace(params=dict(self._slot[0]),
                             comm=new.comm._replace(**self._slot[1]))
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

    def _slot_state(self) -> DecentralizedState:
        """The state the slot holds, with the host fields of the last one."""
        params, comm_t = self._slot
        return DecentralizedState(params, (), self._at[0], self._comm._replace(**comm_t))

    def _copy_comm(self, comm) -> None:
        """The step's new ``CommState`` tensors into the slot's."""
        for f, t in self._slot[1].items():
            if getattr(comm, f) is not t:
                t.copy_(getattr(comm, f))

    def _body(self, prog: _Program):
        """The step from the slot into the slot, its metrics into the
        buffer's column ``prog.col``: what the graph captures."""
        new, m = self._fused(self._slot_state(), prog.batch, prog.eta, out=self._slot[0])
        self._copy_comm(new.comm)
        self._mbuf.index_copy_(1, prog.col, torch.stack([m[k] for k in self._keys])[:, None])

    def _capture(self, prog: _Program) -> None:
        """The graph of ``prog`` on the card, with the counter increments its
        capture made; nothing to capture on the CPU, where :meth:`_replay`
        runs the same body eagerly."""
        if self._card:
            counters = launch_counters()
            before = [getattr(fn, a) for fn, a in counters]
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
                self._body(prog)
            if self._pool is None:
                self._pool = graph.pool()
            prog.graph = graph
            prog.deltas = [(fn, a, getattr(fn, a) - v) for (fn, a), v in zip(counters, before)
                           if getattr(fn, a) != v]
            for (fn, a), v in zip(counters, before):  # a capture launches nothing
                setattr(fn, a, v)
        watchdog.record_capture("train_step")

    # -- replays -----------------------------------------------------------------

    def _pack(self, prog: _Program, batches, lo: int, hi: int, step0: int,
              i0: int) -> torch.Tensor:
        """Steps lo..hi-1's inputs, one row of ``prog.inbuf``'s bytes each;
        the step at ``lo`` is the run's ``i0``-th replay, at step ``step0``."""
        n = hi - lo
        packed = torch.empty((n, prog.inbuf.numel()), dtype=torch.uint8, device=self.device)
        for (off, nb, _, _), b in zip(prog.layout, batches):
            packed[:, off:off + nb].copy_(b[lo:hi].reshape(n, -1).view(torch.uint8))
        head = np.zeros((n, 16), dtype=np.uint8)
        head[:, _COL:_COL + 8] = ((i0 + np.arange(n, dtype=np.int64)) % METRIC_COLS
                                  )[:, None].view(np.uint8)
        etas = np.array([self._lr(step0 + i) for i in range(n)], dtype=np.float32)
        head[:, _ETA:_ETA + 4] = etas[:, None].view(np.uint8)
        head_t = torch.from_numpy(head)
        if self._card:
            head_t = head_t.pin_memory().to(self.device, non_blocking=True)
        packed[:, :16].copy_(head_t)
        return packed

    def _replay(self, prog: _Program) -> None:
        if prog.graph is None:
            self._body(prog)
            return
        prog.graph.replay()
        for fn, a, d in prog.deltas:
            setattr(fn, a, getattr(fn, a) + d)

    def segment(self, state: DecentralizedState, batches, lo: int, hi: int):
        """Steps ``lo..hi-1`` of ``batches`` (every leaf (T, ...) on the
        trainer's device) from ``state``; returns (state, metrics), every
        metric stacked to (hi - lo,)."""
        sig = tuple((tuple(b.shape[1:]), b.dtype) for b in batches)
        prog = self._programs.get(sig)
        parts = []
        if prog is None:  # this program's first step, eager: the warm-up
            state, m = self._warm_up(state, tuple(b[lo] for b in batches))
            parts.append(torch.stack([m[k] for k in self._keys])[:, None])
            lo += 1
            prog = _Program(sig, self.device)
            self._capture(prog)
            self._programs[sig] = prog
        self._take(state)
        if lo < hi:
            for i in range(hi - lo):
                if i % PACK_STEPS == 0:
                    packed = self._pack(prog, batches, lo + i, min(lo + i + PACK_STEPS, hi),
                                        state.step + i, i)
                prog.inbuf.copy_(packed[i % PACK_STEPS])
                self._replay(prog)
                if i % METRIC_COLS == METRIC_COLS - 1 or i == hi - lo - 1:
                    parts.append(self._mbuf[:, :i % METRIC_COLS + 1].clone())
        state = self._state(state, hi - lo)
        ms = torch.cat(parts, 1)
        return state, {k: ms[j] for j, k in enumerate(self._keys)}
