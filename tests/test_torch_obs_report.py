"""The port's run report and regression gate (``python -m repro_torch.obs
report|compare``) against the reference's, over the same faultless JSONL:
the reference's checked-in mini log and a stream the port's train CLI
writes.  Summaries and their text are equal; the compare CLI prints the
same lines and exits with the same codes."""

import json
import os

import pytest

from repro.obs import report as ref_report
from repro_torch.obs import report as port_report

ROOT = os.path.join(os.path.dirname(__file__), "..")
FIXTURE = os.path.join(ROOT, "tests", "data", "mini_log")


@pytest.fixture(scope="module")
def port_log(tmp_path_factory):
    """A 12-step fmnist run of the port's train CLI (K = 4) with --log-dir."""
    from repro_torch.launch import train

    d = tmp_path_factory.mktemp("run")
    train.main(["--paper", "fmnist", "--device", "cpu", "--steps", "12", "--nodes", "4",
                "--graph", "ring", "--log-every", "6", "--compress", "int8",
                "--tap-vectors-every", "4", "--log-dir", str(d)])
    return str(d)


def _normal(obj):
    return json.loads(json.dumps(obj))


@pytest.mark.parametrize("which", ["fixture", "port"])
def test_summaries_and_text_equal_the_reference(which, port_log):
    path = FIXTURE if which == "fixture" else port_log
    ref_recs, recs = ref_report.load_records(path), port_report.load_records(path)
    assert recs == ref_recs
    for target in (None, 0.1, 0.99):
        want = ref_report.summarize_run(ref_recs, target_acc=target)
        got = port_report.summarize_run(recs, target_acc=target)
        assert _normal(got) == _normal(want)
        want.pop("trace_records", None)
        got.pop("trace_records", None)
        assert port_report.render_text(got) == ref_report.render_text(want)
        assert port_report.render_html(got, recs, title="t") == \
            ref_report.render_html(want, ref_recs, title="t")
    if which == "port":
        s = port_report.summarize_run(recs)
        assert s["train"]["records"] == 12 and sum(s["histograms"]["hist_loss_nodes"]) == 12
        assert set(s["fairness"]) >= {"acc_avg", "acc_worst_dist", "acc_spread"}


def _doctor(tmp_path, src, scale_acc):
    with open(os.path.join(src, "telemetry.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    for r in recs:
        if r["kind"] == "eval":
            r["acc_avg"] *= scale_acc
    out = tmp_path / f"doctored{scale_acc}.jsonl"
    out.write_text("".join(json.dumps(r) + "\n" for r in recs))
    return str(out)


@pytest.mark.parametrize("which", ["fixture", "port"])
def test_compare_cli_gives_the_reference_verdicts(which, port_log, tmp_path, capsys):
    base = FIXTURE if which == "fixture" else port_log
    worse = _doctor(tmp_path, base, 0.5)
    bench = tmp_path / "BENCH_x.json"
    bench.write_text(json.dumps({"sink_overhead_pct": 2.0, "on": {"steps_per_s": 50.0}}))
    bench2 = tmp_path / "BENCH_y.json"
    bench2.write_text(json.dumps({"sink_overhead_pct": 2.4, "on": {"steps_per_s": 40.0}}))
    cases = [[base, base], [base, worse, "--max-regression", "10"],
             [base, worse, "--metric", "train.final_loss_mean:10"],
             [base, worse, "--metric", "fairness.acc_avg:60", "--verbose"],
             [str(bench), str(bench2)], [str(bench), str(bench2), "--max-regression", "30"]]
    codes = []
    for args in cases:
        rc_ref = ref_report.main(["compare", *args])
        out_ref = capsys.readouterr().out
        rc = port_report.main(["compare", *args])
        out = capsys.readouterr().out
        assert (rc, out) == (rc_ref, out_ref), args
        codes.append(rc)
    assert codes == [0, 1, 0, 0, 1, 0]


def test_report_cli_renders_text_html_and_trace(port_log, tmp_path, capsys):
    html, trace = tmp_path / "r.html", tmp_path / "t.json"
    assert port_report.main(["report", port_log, "--html", str(html),
                             "--export-trace", str(trace)]) == 0
    out = capsys.readouterr().out
    assert "== fairness ==" in out and "== histograms ==" in out
    assert "<svg" in html.read_text()
    assert json.loads(trace.read_text())["traceEvents"] == []   # no faults, no rate moves
    assert port_report.main(["report", FIXTURE, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["events"] == {"ef_rebase": 2, "rate_switch": 1}
