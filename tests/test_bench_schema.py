"""bench.py emits the one-line JSON artifact the round driver records;
a malformed line would cost a round. Pin the schema cheaply by faking the
expensive measurement functions."""

import json

import numpy as np


def _run_fake_main(monkeypatch, tmp_path):
    import bench

    fake_cell = {"iters_per_s": 100.0, "score_evals_per_s": 3200.0,
                 "mean_err": 0.001, "cov_err": 0.002}

    def fake_matrix(targets):
        return {name: {str(d): dict(fake_cell) for d in (64, 256, 1024)}
                for name in ("gsm", "factor_gsm", "bam")}

    monkeypatch.setenv("BENCH_MATRIX_PATH", str(tmp_path / "m.json"))
    # No compile cache for a fake run (it would stay set for the worker).
    monkeypatch.setattr(bench, "_setup_cache", lambda: None)
    monkeypatch.setattr(bench, "bench_matrix", fake_matrix)
    monkeypatch.setattr(bench, "time_reference_structure", lambda t: 5.0)
    monkeypatch.setattr(bench, "_targets", lambda: {
        256: type("T", (), {"d": 256, "mean": np.zeros(256),
                            "cov": np.eye(256)})()})
    bench.main()
    return tmp_path / "m.json"


def test_bench_main_emits_valid_schema(monkeypatch, capsys, tmp_path):
    matrix_file = _run_fake_main(monkeypatch, tmp_path)
    out = capsys.readouterr().out
    lines = out.strip().splitlines()
    d = json.loads(lines[-1])
    assert d["metric"] == "gsm_iters_per_s_d256_b32"
    assert d["unit"] == "iters/s"
    assert isinstance(d["value"], float) and d["value"] == 100.0
    assert d["vs_baseline"] == 20.0
    assert d["path"] in ("gsm", "factor_gsm")
    # The full matrix rides its OWN earlier line + a file, not the final line.
    m = json.loads(lines[-2])
    assert m["artifact"] == "bench_matrix"
    assert set(m["matrix"]) == {"gsm", "factor_gsm", "bam"}
    with open(matrix_file) as fh:
        assert json.load(fh)["matrix"] == m["matrix"]


def test_bench_final_line_parses_under_tail_window(monkeypatch, capsys,
                                                   tmp_path):
    """The round driver records only a bounded tail of stdout (round 2 lost
    the headline because the matrix-bearing final line truncated mid-JSON).
    The final line must be short AND parse when only the last 2 KB survive."""
    _run_fake_main(monkeypatch, tmp_path)
    out = capsys.readouterr().out
    for window in (2048, 512, 256):
        tail = out[-window:]
        last = tail.strip().splitlines()[-1]
        d = json.loads(last)  # must be complete JSON inside the window
        assert {"metric", "value", "unit", "vs_baseline"} <= set(d)
    # Belt and braces: the final line itself stays well under the window.
    final = out.strip().splitlines()[-1]
    assert len(final) < 220


def test_time_fit_times_one_warm_run(monkeypatch):
    """One untimed warm-up run (compilation), then exactly one timed run:
    it/s = (niter + 1) / elapsed of the second run."""
    import bench

    class T:
        d = 4
        mean = np.zeros(4)
        cov = np.eye(4)

    calls = []
    seq = iter([10.0, 12.0])  # t0, t1 of the timed run only
    monkeypatch.setattr(bench.time, "perf_counter", lambda: next(seq))

    def run(n):
        calls.append(n)
        return np.zeros(4), np.eye(4)

    ips, em, ec = bench._time_fit(run, 99, T())
    assert calls == [99, 99]
    assert ips == 50.0
    assert (em, ec) == (0.0, 0.0)
