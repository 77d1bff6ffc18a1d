"""Run reports (the part of ``repro.obs`` the serving engine needs; the
telemetry sink, traces and watchdog are ROADMAP A.13)."""

from repro_torch.obs.report import serve_latency_summary

__all__ = ["serve_latency_summary"]
