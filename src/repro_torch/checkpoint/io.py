"""MessagePack pytree checkpoints (the port of ``repro.checkpoint.io``).

Layout: ``<dir>/step_<n:08d>/state.msgpack`` + ``manifest.json``, as the
reference writes it.  A tree is encoded node by node: a tensor or array as
``{"__array__": True, "dtype": name, "shape": [...], "data": raw bytes}``,
a Python scalar as ``{"__scalar__": True, "value": v}``, a dict as
``{"__dict__": {...}}``, a list or tuple as ``{"__seq__": [...], "tuple":
bool}`` and None as ``{"__none__": True}``; so a file either package wrote
restores in the other.  Tensors go to host numpy through ``.cpu()``.
bfloat16, which numpy lacks, is written as its raw 2-byte words under the
dtype name ``"bfloat16"`` (the name the reference's ``ml_dtypes`` gives it)
and read back with ``torch.frombuffer``.  The MessagePack codec is the
port's own (``_msgpack.py``, the format's subset): the card's install has
no ``msgpack`` package.

The whole state is packed in host memory, as in the reference, and
MessagePack's ``bin32`` holds at most 2**32 - 1 bytes per leaf: a larger
leaf (qwen2-0.5b's tied embedding node-stacked at K = 8 is 4.36 GB) raises
naming the leaf, where the reference's packer fails too.

:func:`save_train_state` / :func:`restore_train_state` persist the full
``DecentralizedState`` with its ``CommState``, in the reference's layout:
params, ``hat``, ``hat_mix`` and each of ``track``'s dicts nested
(``utils.tree.unflatten``), ``step``, ``rounds`` and ``ef_rounds`` as 0-d
int32 arrays, and ``key`` as two uint32 words.  Three fields are host
values in the port where the reference keeps arrays, and restore so:

* ``step`` (``core/drdsgd.py``), ``rounds`` and ``ef_rounds``: ``int`` of
  the stored 0-d int32 (``ef_rounds`` stays ``()`` where it is empty);
* ``key``: the port's key is the wire's integer seed, the reference's a
  JAX ``uint32[2]`` PRNG key.  The port writes its seed as ``[seed >> 32,
  seed & 0xFFFFFFFF]``, which is what ``jax.random.PRNGKey(seed)`` holds,
  and restores ``(hi << 32) | lo``.  A reference key its mixer never
  consumed (every uncompressed stack) restores as its seed; a consumed key
  (the reference splits it every compressed round) restores as that 64-bit
  number, a seed of the port's own uniforms: the port cannot continue the
  reference's stream, so a stochastic wire is held port to port only.

A resumed run continues bit-exactly: the topology's and the faults' coins
are pure functions of the restored ``rounds``.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack
from repro_torch.device import resolve_device
from repro_torch.utils.tree import flatten, unflatten

_ARRAY_KEY = "__array__"
_SCALAR_KEY = "__scalar__"
BIN32_MAX = 2**32 - 1   # MessagePack's largest bin, the most bytes one leaf may hold


def _host_array(x):
    """(dtype name, shape, raw bytes) of a tensor or array on the host."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", list(t.shape), t.view(torch.int16).numpy().tobytes()
        x = t.numpy()
    arr = np.asarray(x)
    return arr.dtype.name, list(arr.shape), arr.tobytes()  # C order whatever the strides


def _encode(node, path: str = ""):
    if isinstance(node, (torch.Tensor, np.ndarray, np.generic)):
        dtype, shape, data = _host_array(node)
        if len(data) > BIN32_MAX:
            raise ValueError(
                f"checkpoint leaf {path or '<root>'!r} ({dtype}{shape}) holds {len(data):,} "
                f"bytes, over MessagePack's bin32 limit of {BIN32_MAX:,} bytes per leaf")
        return {_ARRAY_KEY: True, "dtype": dtype, "shape": shape, "data": data}
    if isinstance(node, (int, float, bool, str, bytes)):
        return {_SCALAR_KEY: True, "value": node}
    if isinstance(node, dict):
        return {"__dict__": {k: _encode(v, f"{path}/{k}" if path else str(k))
                             for k, v in node.items()}}
    if isinstance(node, (list, tuple)):
        return {"__seq__": [_encode(v, f"{path}[{i}]") for i, v in enumerate(node)],
                "tuple": isinstance(node, tuple)}
    if node is None:
        return {"__none__": True}
    raise TypeError(f"cannot checkpoint leaf of type {type(node)}")


def _decode(node):
    """The stored tree on the host: numpy arrays, bfloat16 as CPU tensors."""
    if _ARRAY_KEY in node:
        if node["dtype"] == "bfloat16":
            flat = torch.frombuffer(bytearray(node["data"]), dtype=torch.bfloat16)
            return flat.reshape(node["shape"])
        arr = np.frombuffer(node["data"], dtype=np.dtype(node["dtype"]))
        return arr.reshape(node["shape"]).copy()
    if _SCALAR_KEY in node:
        return node["value"]
    if "__dict__" in node:
        return {k: _decode(v) for k, v in node["__dict__"].items()}
    if "__seq__" in node:
        seq = [_decode(v) for v in node["__seq__"]]
        return tuple(seq) if node.get("tuple") else seq
    if "__none__" in node:
        return None
    raise ValueError(f"malformed checkpoint node: keys={list(node)}")


def _to_device(node, device: torch.device):
    if isinstance(node, np.ndarray):
        return torch.from_numpy(node).to(device)
    if isinstance(node, torch.Tensor):
        return node.to(device)
    if isinstance(node, dict):
        return {k: _to_device(v, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        seq = [_to_device(v, device) for v in node]
        return tuple(seq) if isinstance(node, tuple) else seq
    return node


def save_checkpoint(ckpt_dir: str, step: int, state) -> str:
    """Serialize a tree of tensors, arrays and Python values to
    ``<ckpt_dir>/step_<step:08d>/state.msgpack``; returns that directory."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    blob = _msgpack.packb(_encode(state))
    tmp = os.path.join(path, "state.msgpack.tmp")
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, os.path.join(path, "state.msgpack"))
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"step": step, "bytes": len(blob)}, f)
    return path


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(m.group(1))
        for d in os.listdir(ckpt_dir)
        if (m := re.fullmatch(r"step_(\d+)", d))
        and os.path.exists(os.path.join(ckpt_dir, d, "state.msgpack"))
    ]
    return max(steps) if steps else None


def _read(ckpt_dir: str, step: int | None):
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "state.msgpack")
    with open(path, "rb") as f:
        return _decode(_msgpack.unpackb(f.read())), step


def restore_checkpoint(ckpt_dir: str, step: int | None = None, device="cuda"):
    """Load a checkpoint (the latest when ``step`` is None): ``(tree,
    step)`` with every array a tensor on ``device`` and every scalar a
    Python value."""
    tree, step = _read(ckpt_dir, step)
    return _to_device(tree, resolve_device(device)), step


# Zero-padding for CommState fields missing from older checkpoints, keyed by
# field name.  Every CommState field has an entry: restore refuses to guess.
# () is the protocol's empty slot, which every mixer that predates a field
# expects.
COMM_STATE_PAD = {
    "hat": (),
    "hat_mix": (),
    "key": (),
    "res_norm": (),
    "res_ref": (),
    "rounds": (),
    "wire_bits": (),
    "track": (),
    "ef_rounds": (),
    "ef_drift": (),
}


def _pad_comm_fields(stored: tuple) -> tuple:
    """Extend a positionally stored CommState tuple to the current schema."""
    from repro_torch.comm.protocol import CommState

    missing = [f for f in CommState._fields if f not in COMM_STATE_PAD]
    if missing:
        raise KeyError(
            f"CommState fields {missing} have no COMM_STATE_PAD entry — add "
            "one (repro_torch/checkpoint/io.py) so old checkpoints keep restoring")
    if len(stored) > len(CommState._fields):
        raise ValueError(
            f"checkpoint CommState has {len(stored)} fields but the current "
            f"schema has {len(CommState._fields)} — written by a newer repo?")
    pad = tuple(COMM_STATE_PAD[f] for f in CommState._fields[len(stored):])
    return tuple(stored) + pad


def _int32(n: int) -> np.ndarray:
    return np.asarray(n, np.int32)


def _nested(tree):
    """A flat parameter-shaped dict in the reference's nesting; () as is."""
    return unflatten(tree) if isinstance(tree, dict) else tree


def _flat(tree, device):
    """A stored parameter-shaped dict as the port's flat dict (sorted
    keys) of tensors on ``device``; () as is."""
    if not isinstance(tree, dict):
        return tree
    flat = flatten(tree)
    return {name: _to_device(flat[name], device) for name in sorted(flat)}


def _host_int(stored, empty):
    """A stored 0-d int32 (or a Python int) as a host int; an empty slot
    as ``empty``."""
    return empty if isinstance(stored, tuple) else int(stored)


def _seed(key) -> int:
    """The port's wire seed from a stored key: ``(hi << 32) | lo`` of its
    two uint32 words (0 for an empty slot)."""
    if isinstance(key, tuple):
        return 0
    hi, lo = (int(w) for w in np.asarray(key).reshape(2))
    return (hi << 32) | lo


def save_train_state(ckpt_dir: str, step: int, state) -> str:
    """Persist a full :class:`repro_torch.core.DecentralizedState`, its
    ``CommState`` included, in the reference's layout."""
    from repro_torch.comm.protocol import CommState

    comm = state.comm
    if isinstance(comm, CommState):
        key = int(comm.key)
        comm = comm._replace(
            hat=_nested(comm.hat), hat_mix=_nested(comm.hat_mix),
            key=np.asarray([key >> 32, key & 0xFFFFFFFF], np.uint32),
            rounds=_int32(comm.rounds),
            track=tuple(_nested(t) for t in comm.track),
            ef_rounds=comm.ef_rounds if comm.ef_rounds == () else _int32(comm.ef_rounds))
    return save_checkpoint(ckpt_dir, step, {
        "params": unflatten(state.params), "opt_state": state.opt_state,
        "step": _int32(state.step), "comm": comm})


def restore_train_state(ckpt_dir: str, step: int | None = None, device="cuda"):
    """Load a :func:`save_train_state` checkpoint of either package as a
    typed ``(DecentralizedState, step)`` on ``device``.

    The CommState is rebuilt field by field; a checkpoint written before a
    CommState field existed (pre-``track``, pre-``ef_rounds``) is padded
    with empty slots, which is what every mixer that predates the field
    expects.  The host fields restore as the module docstring says.
    """
    from repro_torch.comm.protocol import CommState
    from repro_torch.core.drdsgd import DecentralizedState

    dev = resolve_device(device)
    raw, step = _read(ckpt_dir, step)
    if not isinstance(raw, dict) or "params" not in raw:
        raise ValueError(
            f"checkpoint at {ckpt_dir} step {step} is not a train state "
            f"(keys: {sorted(raw) if isinstance(raw, dict) else type(raw)})")
    comm = raw.get("comm", ())
    if isinstance(comm, (list, tuple)) and len(comm) > 0:
        c = CommState(*_pad_comm_fields(tuple(comm)))
        comm = CommState(
            hat=_flat(c.hat, dev), hat_mix=_flat(c.hat_mix, dev), key=_seed(c.key),
            res_norm=_to_device(c.res_norm, dev), res_ref=_to_device(c.res_ref, dev),
            rounds=_host_int(c.rounds, 0), wire_bits=_to_device(c.wire_bits, dev),
            track=tuple(_flat(t, dev) for t in c.track),
            ef_rounds=_host_int(c.ef_rounds, ()), ef_drift=_to_device(c.ef_drift, dev))
    state = DecentralizedState(
        params=_flat(raw["params"], dev),
        opt_state=_to_device(raw.get("opt_state", ()), dev),
        step=int(raw["step"]),
        comm=comm)
    return state, step
