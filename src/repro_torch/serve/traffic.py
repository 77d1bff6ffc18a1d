"""Open-loop traffic: Poisson arrivals over mixed request classes (the
port of ``repro.serve.traffic``; numpy only, so a seed gives the
reference's trace).

Open loop: arrival times are drawn once, up front, independent of how fast
the engine drains them, which is what exposes queueing delay in the p99
tail.  Every request carries its class label, and the engine's latency
summary aggregates TTFT and per-token latency per class.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serve.scheduler import Request


@dataclasses.dataclass(frozen=True)
class TrafficClass:
    """One request population: fixed prompt length, uniform gen budget."""

    name: str
    prompt_len: int
    gen_min: int
    gen_max: int
    weight: float = 1.0
    temperature: float = 0.0


#: small mixed workload for smoke runs: short chatty requests plus a
#: minority of long-prompt short-answer ones (the tail-maker)
SMOKE_CLASSES = (
    TrafficClass("chat", prompt_len=6, gen_min=4, gen_max=10, weight=3.0),
    TrafficClass("doc", prompt_len=20, gen_min=2, gen_max=6, weight=1.0),
)


def poisson_trace(classes, *, rate: float, horizon: float, vocab: int,
                  seed: int = 0) -> list[Request]:
    """Draw one open-loop trace: exponential gaps at ``rate`` requests per
    time unit until ``horizon``; class by weight; gen budget ~ U[gen_min,
    gen_max].  The time unit is the engine clock's (seconds for
    ``clock="wall"``, decode steps for ``clock="steps"``)."""
    rng = np.random.default_rng(seed)
    classes = tuple(classes)
    w = np.asarray([c.weight for c in classes], np.float64)
    w = w / w.sum()
    reqs: list[Request] = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / rate)
        if t >= horizon:
            break
        c = classes[int(rng.choice(len(classes), p=w))]
        reqs.append(Request(
            rid=len(reqs),
            prompt=rng.integers(0, vocab, (c.prompt_len,)).astype(np.int32),
            max_new=int(rng.integers(c.gen_min, c.gen_max + 1)),
            temperature=c.temperature,
            arrival=float(t),
            cls=c.name,
        ))
    return reqs
