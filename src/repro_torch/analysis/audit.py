"""Host-synchronisation audit (the torch counterpart of
``repro.analysis.audit.audit_host_callbacks``).

The reference proves a compiled step stages no stray host callback by
reading its jaxpr.  Eager PyTorch has no program to read, so the port counts
what a call does that waits on the card, the two ways CUDA lets a process
see it:

* ``debug_mode``: the synchronising calls CUDA's sync debug mode
  (``torch.cuda.set_sync_debug_mode("warn")``) reports;
* ``runtime_syncs`` / ``dtoh_copies``: under ``torch.profiler``, the CUDA
  runtime's synchronise calls and the device-to-host copies.

The reference's other audits (the wire's collective-permute bytes, donation,
baked constants and recompiles) read XLA's HLO and have no counterpart on
one card in eager PyTorch.
"""

from __future__ import annotations

import warnings

import torch


def audit_host_syncs(fn, *args, **kwargs) -> dict:
    """Call ``fn(*args, **kwargs)`` twice, once under CUDA's sync debug mode
    and once under the profiler, and count its synchronisations:
    ``{"debug_mode", "runtime_syncs", "dtoh_copies"}``.  ``fn`` must be safe
    to call twice on the same arguments.  Raises without a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("audit_host_syncs needs a CUDA device: it counts what "
                           "waits on the card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(*args, **kwargs)
    torch.cuda.synchronize()
    events = prof.events()
    return dict(
        # the mode's own one-time "prototype feature" notice is not a sync
        debug_mode=sum(1 for w in caught
                       if "called a synchronizing CUDA operation" in str(w.message)),
        runtime_syncs=sum(1 for e in events if e.device_type == DeviceType.CPU
                          and "Synchronize" in e.name),
        dtoh_copies=sum(1 for e in events if e.device_type == DeviceType.CUDA
                        and "DtoH" in e.name))


def fmnist_step_syncs(compress: str = "none", device="cuda") -> dict:
    """One step of the paper's fmnist configuration (the train CLI's:
    ``fmnist_default()``, ER(p) with Metropolis W), audited with the
    telemetry sink and the sanitizer off and on.

    Returns ``{"off": {...}, "on": {...}}``, each with the counts of a step
    whose record carries only scalars (step 1) and of one that also carries
    the per-node vectors and histograms (step 8).  Step 0 runs first
    unaudited: it builds the kernels and copies the histogram edges to the
    card.  The audited call is the step function ``trainer.run`` loops
    over: the sink's drain and the sanitizer's read happen once per
    segment, outside it.
    """
    import numpy as np

    from repro_torch.configs import fmnist_default
    from repro_torch.core import TrainerSpec
    from repro_torch.data import make_fmnist_like, pathological_noniid_partition
    from repro_torch.models import make_classifier_loss, mlp_apply, mlp_init
    from repro_torch.obs import MetricsSink

    exp = fmnist_default()
    fed = pathological_noniid_partition(make_fmnist_like(), exp.num_nodes, seed=0)
    batch = fed.sample_batch(np.random.default_rng(0), exp.batch_size)
    out = {}
    for mode in ("off", "on"):
        sink = MetricsSink() if mode == "on" else None
        spec = TrainerSpec(num_nodes=exp.num_nodes, graph="erdos_renyi",
                           graph_kwargs={"p": exp.p, "seed": 0}, lr=exp.lr, mu=exp.mu,
                           compress=compress, sanitize=mode == "on", device=device)
        trainer = spec.build(make_classifier_loss(mlp_apply), mlp_apply, obs=sink)
        state = trainer.init(mlp_init(torch.Generator().manual_seed(0)))
        b = trainer._batch(batch)
        state, _ = trainer._train_step(state, b)
        out[mode] = {f"step {s}": audit_host_syncs(trainer._train_step, state._replace(step=s), b)
                     for s in (1, 8)}
    return out
