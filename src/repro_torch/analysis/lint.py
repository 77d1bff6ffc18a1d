"""Repo-discipline linter: AST rules for the port's training stack (the port
of ``repro.analysis.lint``, with the rules that mean something in eager
PyTorch on one card).

A generic linter does not know that a ``float()`` inside a train step waits
for the card, or that a new ``CommState`` field silently breaks old
checkpoints.  These rules encode the repo's own discipline:

  RPR001  Python ``if``/``while`` on a tensor value inside a step or mix
          function.  On the card the branch reads the value back: a host
          synchronisation every step.  Branch on host state (the step
          counter, ``rounds``, config), or keep the choice on the device
          with ``torch.where``.
  RPR002  Host materialization of a tensor derived from a step or mix
          function's arguments: ``float()`` / ``int()`` / ``bool()`` /
          ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``np.asarray()`` /
          ``np.array()``.  Each is a synchronisation on the card.
  RPR004  Device allocation at import time: module-level tensor factories
          (``torch.zeros``, ``torch.tensor``, ...), ``.cuda()`` and
          ``torch.cuda.*`` calls.  They touch (or initialize) the device
          before an entry point has chosen it.
  RPR005  CommState schema discipline: every field of the NamedTuple must
          be registered in the checkpoint zero-padding table
          (``repro_torch.checkpoint.io.COMM_STATE_PAD``) and the table may
          name no other; and ``CommState(...)`` may only be constructed in
          the protocol module or inside ``init_state``/``state_specs`` hooks
          and the checkpoint's restore — everywhere else use
          ``state._replace(...)`` so adding a field cannot silently drop it.

The reference's RPR003, RPR006 and RPR007 are about pjit partition specs
and ``io_callback``; they have no meaning here.

Suppression: append ``# repro: noqa`` (all rules) or
``# repro: noqa[RPR002]`` (specific rules) to the flagged line, with the
reason beside it.

Step and mix functions are found statically: ``__call__``/``_mix``/
``mix_tree`` methods of Mixer classes, the per-round layer methods of
``*Topology`` / ``*Transport`` / ``*Wire`` classes (``round_w``;
``apply_w``/``apply``; ``encode_leaves``/``rate``/``next_sched_state``/
``round_wire_bits``/``gamma_for``), functions named ``train_step``/
``eval_step``, nested ``def``s inside those, and (one fixed point) any
same-module function or ``self.`` method they call.  Inside them the
arguments (minus ``self``/``cls``) and what is assigned from them count as
tensors.

Run it: ``python -m repro_torch.analysis [paths...]`` (exits 1 on findings).
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re

_TRACED_SEED_METHODS = {"__call__", "_mix", "mix_tree"}
_TRACED_SEED_NAMES = {"train_step", "eval_step"}
# consensus-layer classes (matched by name suffix) and the methods of each
# that run inside a round
_LAYER_TRACED_METHODS = {
    "Topology": {"round_w"},
    "Transport": {"apply_w", "apply"},
    "Wire": {"encode_leaves", "rate", "next_sched_state", "round_wire_bits", "gamma_for"},
}
# where CommState(...) construction is legitimate
_COMMSTATE_CTOR_FNS = {"init_state", "state_specs", "trivial_comm_state",
                       "_pad_comm_fields", "restore_train_state"}
_HOST_CASTS = {"float", "int", "bool"}
_HOST_METHODS = {"item", "tolist", "cpu"}
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "size", "itemsize"}
_STATIC_CALLS = {"isinstance", "hasattr", "getattr", "len", "callable",
                 "issubclass", "type"}
# module-level calls that allocate on (or initialize) a device
_TENSOR_FACTORIES = {"tensor", "as_tensor", "from_numpy", "zeros", "ones", "empty", "full",
                     "rand", "randn", "randint", "arange", "linspace", "eye", "zeros_like",
                     "ones_like", "empty_like", "full_like", "Generator"}

_NOQA_RE = re.compile(r"#\s*repro:\s*noqa(?:\[([A-Z0-9, ]+)\])?")


@dataclasses.dataclass(frozen=True)
class LintFinding:
    path: str
    line: int
    code: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.code} {self.message}"


def _noqa_map(source: str) -> dict[int, set[str] | None]:
    """line -> suppressed codes (None = all) from ``# repro: noqa`` marks."""
    out: dict[int, set[str] | None] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _NOQA_RE.search(line)
        if not m:
            continue
        codes = m.group(1)
        out[i] = (None if codes is None
                  else {c.strip() for c in codes.split(",") if c.strip()})
    return out


def _attr_chain(node) -> list[str]:
    """a.b.c -> ["a", "b", "c"]; [] when the root is not a plain Name."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return parts
    return []


def _call_name(node: ast.Call) -> str:
    """Last path component of the called object ("torch.cuda.synchronize" ->
    "synchronize")."""
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


class _TaintWalker(ast.NodeVisitor):
    """Collect Name ids that (syntactically) carry tensor values, skipping
    subtrees evaluated on the host (isinstance/len/shape/... and `is None`)."""

    def __init__(self, tainted: set[str]):
        self.tainted = tainted
        self.hits: list[str] = []

    def visit_Call(self, node: ast.Call):
        if _call_name(node) in _STATIC_CALLS:
            return
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute):
        if node.attr in _STATIC_ATTRS:
            return
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name):
        if node.id in self.tainted:
            self.hits.append(node.id)


def _traced_names_in(node, tainted: set[str]) -> list[str]:
    w = _TaintWalker(tainted)
    w.visit(node)
    return w.hits


def _function_index(tree: ast.Module):
    """(module_fns, classes) where classes -> {name: (node, {method: fn})}."""
    module_fns: dict[str, ast.FunctionDef] = {}
    classes: dict[str, tuple[ast.ClassDef, dict]] = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            module_fns[node.name] = node
        elif isinstance(node, ast.ClassDef):
            methods = {n.name: n for n in node.body
                       if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
            classes[node.name] = (node, methods)
    return module_fns, classes


def _is_mixer_class(cls: ast.ClassDef, classes: dict) -> bool:
    for base in cls.bases:
        chain = _attr_chain(base)
        name = chain[-1] if chain else ""
        if "Mixer" in name or "Mixer" in cls.name:
            return True
        if name in classes and _is_mixer_class(classes[name][0], classes):
            return True
    return "Mixer" in cls.name


def _find_traced_functions(tree: ast.Module):
    """Set of FunctionDef nodes that run inside a step or a round."""
    module_fns, classes = _function_index(tree)
    traced: set[ast.AST] = set()
    for cls_name, (cls, methods) in classes.items():
        if _is_mixer_class(cls, classes):
            traced |= {methods[m] for m in _TRACED_SEED_METHODS if m in methods}
        for suffix, layer_methods in _LAYER_TRACED_METHODS.items():
            if cls_name.endswith(suffix):
                traced |= {methods[m] for m in layer_methods if m in methods}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name in _TRACED_SEED_NAMES:
            traced.add(node)
    # fixed point: nested defs + same-module / self. calls from traced fns
    changed = True
    while changed:
        changed = False
        for fn in list(traced):
            for node in ast.walk(fn):
                if node is not fn and isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if node not in traced:
                        traced.add(node)
                        changed = True
                if isinstance(node, ast.Call):
                    callee = None
                    f = node.func
                    if isinstance(f, ast.Name) and f.id in module_fns:
                        callee = module_fns[f.id]
                    elif (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                          and f.value.id == "self"):
                        for _, (cls, methods) in classes.items():
                            if fn in methods.values() and f.attr in methods:
                                callee = methods[f.attr]
                                break
                    if callee is not None and callee not in traced:
                        traced.add(callee)
                        changed = True
    return traced


def _taint_set(fn) -> set[str]:
    """Tensor-valued names inside one step or mix function: its parameters
    (minus self/cls) plus locals assigned from them."""
    args = fn.args
    names = {a.arg for a in (args.posonlyargs + args.args + args.kwonlyargs)}
    for a in (args.vararg, args.kwarg):
        if a is not None:
            names.add(a.arg)
    names -= {"self", "cls"}
    changed = True
    while changed:
        changed = False
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and _traced_names_in(node.value, names):
                for tgt in node.targets:
                    for n in ast.walk(tgt):
                        if isinstance(n, ast.Name) and n.id not in names:
                            names.add(n.id)
                            changed = True
    return names


def _lint_traced_fn(fn, path: str, findings: list[LintFinding]) -> None:
    tainted = _taint_set(fn)
    nested = {n for n in ast.walk(fn)
              if n is not fn and isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}

    def owned(node):
        # statements inside nested defs are linted as their own functions
        return not any(sub.lineno <= node.lineno <= (sub.end_lineno or sub.lineno)
                       for sub in nested)

    for node in ast.walk(fn):
        if isinstance(node, (ast.If, ast.While)) and owned(node):
            hits = _traced_names_in(node.test, tainted)
            if hits:
                kw = "while" if isinstance(node, ast.While) else "if"
                findings.append(LintFinding(
                    path, node.lineno, "RPR001",
                    f"python `{kw}` on tensor value(s) {sorted(set(hits))} inside step/mix "
                    f"function `{fn.name}` — a host sync per call; use torch.where"))
        if isinstance(node, ast.Call) and owned(node):
            name = _call_name(node)
            chain = _attr_chain(node.func)
            is_np_cast = (len(chain) >= 2 and chain[0] in ("np", "numpy")
                          and chain[-1] in ("asarray", "array"))
            is_host_cast = isinstance(node.func, ast.Name) and name in _HOST_CASTS
            is_method = isinstance(node.func, ast.Attribute) and name in _HOST_METHODS
            if not (is_np_cast or is_host_cast or is_method):
                continue
            probe = (node.func.value if is_method
                     else ast.Tuple(elts=list(node.args), ctx=ast.Load()))
            hits = _traced_names_in(probe, tainted)
            if hits:
                what = f".{name}()" if is_method else f"{name}()"
                findings.append(LintFinding(
                    path, node.lineno, "RPR002",
                    f"host materialization {what} of tensor value(s) {sorted(set(hits))} "
                    f"inside step/mix function `{fn.name}` — a host sync per call"))


def _lint_import_time_device(tree: ast.Module, path: str,
                             findings: list[LintFinding]) -> None:
    """RPR004: tensor factories, .cuda() and torch.cuda calls in module scope."""

    def check_expr(node):
        for call in ast.walk(node):
            if not isinstance(call, ast.Call):
                continue
            chain = _attr_chain(call.func)
            bad = ((len(chain) >= 2 and chain[0] == "torch" and chain[-1] in _TENSOR_FACTORIES)
                   or (len(chain) >= 3 and chain[:2] == ["torch", "cuda"]
                       and chain[-1] != "is_available")
                   or (isinstance(call.func, ast.Attribute) and call.func.attr == "cuda"))
            if bad:
                what = ".".join(chain) if chain else f".{call.func.attr}"
                findings.append(LintFinding(
                    path, call.lineno, "RPR004",
                    f"device allocation at import time: {what}() in module scope — "
                    "touches the device before an entry point has chosen it"))

    for node in tree.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.Expr)):
            check_expr(node)


def _lint_commstate_ctor(tree: ast.Module, path: str,
                         findings: list[LintFinding]) -> None:
    """RPR005 (per-file half): CommState(...) outside the allowed hooks."""
    if os.path.basename(path) == "protocol.py":
        return
    allowed_spans: list[tuple[int, int]] = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name in _COMMSTATE_CTOR_FNS:
            allowed_spans.append((node.lineno, node.end_lineno or node.lineno))
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and _call_name(node) == "CommState"):
            continue
        if any(a <= node.lineno <= b for a, b in allowed_spans):
            continue
        findings.append(LintFinding(
            path, node.lineno, "RPR005",
            "CommState(...) constructed outside init_state/state_specs — "
            "use state._replace(...) so new fields cannot be dropped"))


def lint_source(source: str, path: str = "<string>") -> list[LintFinding]:
    """All single-file findings for one module's source text."""
    tree = ast.parse(source)
    findings: list[LintFinding] = []
    for fn in _find_traced_functions(tree):
        _lint_traced_fn(fn, path, findings)
    _lint_import_time_device(tree, path, findings)
    _lint_commstate_ctor(tree, path, findings)
    noqa = _noqa_map(source)
    kept = []
    for f in findings:
        codes = noqa.get(f.line, ...)
        if codes is ...:
            kept.append(f)
        elif codes is not None and f.code not in codes:
            kept.append(f)
    return sorted(kept, key=lambda f: (f.path, f.line, f.code))


def _parse_commstate_fields(protocol_src: str) -> list[str]:
    tree = ast.parse(protocol_src)
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == "CommState":
            return [n.target.id for n in node.body
                    if isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name)]
    return []


def _parse_pad_table(io_src: str) -> list[str] | None:
    tree = ast.parse(io_src)
    for node in tree.body:
        if isinstance(node, ast.Assign):
            names = [t.id for t in node.targets if isinstance(t, ast.Name)]
            if "COMM_STATE_PAD" in names and isinstance(node.value, ast.Dict):
                return [k.value for k in node.value.keys if isinstance(k, ast.Constant)]
    return None


def lint_schema(protocol_path: str, io_path: str) -> list[LintFinding]:
    """RPR005 (cross-file half): CommState fields vs the checkpoint pad table."""
    findings: list[LintFinding] = []
    with open(protocol_path) as f:
        fields = _parse_commstate_fields(f.read())
    with open(io_path) as f:
        pad = _parse_pad_table(f.read())
    if pad is None:
        findings.append(LintFinding(
            io_path, 1, "RPR005",
            "COMM_STATE_PAD table not found — checkpoint restore cannot "
            "zero-pad CommState fields from older runs"))
        return findings
    for field in fields:
        if field not in pad:
            findings.append(LintFinding(
                protocol_path, 1, "RPR005",
                f"CommState field {field!r} missing from the checkpoint zero-padding "
                "table (repro_torch.checkpoint.io.COMM_STATE_PAD) — old checkpoints "
                "would fail to restore"))
    for field in pad:
        if field not in fields:
            findings.append(LintFinding(
                io_path, 1, "RPR005",
                f"COMM_STATE_PAD entry {field!r} is not a CommState field (stale table?)"))
    return findings


def _iter_py_files(paths):
    for p in paths:
        if os.path.isfile(p):
            yield p
        else:
            for root, _dirs, files in os.walk(p):
                if "__pycache__" in root:
                    continue
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)


def lint_paths(paths) -> list[LintFinding]:
    """Lint every .py under ``paths``; adds the cross-file schema check when
    the port's protocol and checkpoint modules are both in scope."""
    findings: list[LintFinding] = []
    protocol_path = io_path = None
    for path in _iter_py_files(paths):
        with open(path) as f:
            src = f.read()
        try:
            findings.extend(lint_source(src, path))
        except SyntaxError as e:
            findings.append(LintFinding(path, e.lineno or 1, "RPR000",
                                        f"syntax error: {e.msg}"))
        norm = path.replace(os.sep, "/")
        if norm.endswith("repro_torch/comm/protocol.py"):
            protocol_path = path
        if norm.endswith("repro_torch/checkpoint/io.py"):
            io_path = path
    if protocol_path and io_path:
        findings.extend(lint_schema(protocol_path, io_path))
    return findings


def main(argv=None) -> int:
    """The linter's command line (the reference's ``lint.main``): lint
    ``paths`` (default ``src/repro_torch``, else ``.``), print each finding
    and return 1 when there is one, else print that the tree is clean and
    return 0."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repo-discipline linter (rules RPR001, RPR002, RPR004, RPR005)")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/directories to lint (default: src/repro_torch or .)")
    args = ap.parse_args(argv)
    default = os.path.join("src", "repro_torch")
    paths = args.paths or ([default] if os.path.isdir(default) else ["."])
    findings = lint_paths(paths)
    for f in findings:
        print(f)
    if findings:
        print(f"{len(findings)} finding(s)")
        return 1
    print("repro_torch.analysis.lint: clean")
    return 0
