"""CLI: ``python -m repro_torch.analysis [paths...]`` — the repo-discipline
linter (default: ``src/repro_torch``).

``--audit-smoke`` also counts the synchronisations of one fmnist step on
the card with the telemetry sink and the sanitizer off and on (the dense
wire through B.1 and the int8 wire through B.2), and fails if on makes
more than off.  It raises without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys


def _audit_smoke() -> int:
    from repro_torch.analysis.audit import fmnist_step_syncs

    rc = 0
    for compress in ("none", "int8"):
        counts = fmnist_step_syncs(compress)
        worse = [(step, key) for step, c in counts["on"].items() for key in c
                 if c[key] > counts["off"][step][key]]
        print(f"audit[fmnist {compress}]: {'FAIL' if worse else 'ok'} {json.dumps(counts)}")
        rc = max(rc, 1 if worse else 0)
    return rc


def main(argv=None) -> int:
    """The linter's command line, :func:`repro_torch.analysis.lint.main`,
    plus ``--audit-smoke``."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repo-discipline linter (RPR001, RPR002, RPR004, RPR005) + "
                    "host-sync audit smoke")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/directories to lint (default: src/repro_torch)")
    ap.add_argument("--audit-smoke", action="store_true",
                    help="also count one fmnist step's synchronisations on the card "
                         "with the sink and the sanitizer off and on")
    args = ap.parse_args(argv)

    from repro_torch.analysis.lint import main as lint_main

    rc = lint_main(args.paths or [])
    if args.audit_smoke:
        rc = max(rc, _audit_smoke())
    return rc


if __name__ == "__main__":
    sys.exit(main())
