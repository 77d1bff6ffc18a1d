"""Static analysis and the runtime sanitizer for the port's training stack
(the port of ``repro.analysis``).

* ``repro_torch.analysis.lint`` — the AST repo-discipline linter (rules
  RPR001, RPR002, RPR004, RPR005), runnable as ``python -m
  repro_torch.analysis [paths]``.  Pure stdlib.
* ``repro_torch.analysis.sanitize`` — the in-step invariant checks staged
  by ``TrainerSpec(sanitize=True)`` / ``--sanitize``, written to device
  flags and raised at a segment's end.
* ``repro_torch.analysis.audit`` — :func:`audit_host_syncs`, the count of a
  call's synchronisations on the card (``--audit-smoke``).
"""

from repro_torch.analysis.audit import audit_host_syncs
from repro_torch.analysis.lint import LintFinding, lint_paths, lint_schema, lint_source
from repro_torch.analysis.sanitize import SanitizeError, SanitizeFlags, step_checks

__all__ = ["LintFinding", "SanitizeError", "SanitizeFlags", "audit_host_syncs",
           "lint_paths", "lint_schema", "lint_source", "step_checks"]
