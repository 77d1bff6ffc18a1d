"""``python -m repro_torch.obs`` — the report / compare CLI (repro_torch.obs.report)."""

from repro_torch.obs.report import main

if __name__ == "__main__":
    raise SystemExit(main())
