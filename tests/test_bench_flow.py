"""The driver-bench orchestration contract.

``bench.py`` is the artifact the driver records each round; its
orchestration must (a) emit a VALID JSON headline line as soon as the
kriging number exists — an outer timeout can land at any point — (b)
re-emit the accumulating line after every section/extra, (c) degrade a
failed or budget-expired section to a ``skipped`` entry instead of
erasing the run, and (d) fail every device section off the GPU instead
of timing the CPU. Sections are stubbed: this tests the flow, not the
kernels (those have their own suites).
"""

import contextlib
import io
import json

import pytest


@pytest.fixture()
def bench_mod(monkeypatch, tmp_path):
    import bench

    monkeypatch.setenv("GLOMAR_BENCH_BUDGET_S", "0")
    monkeypatch.setattr(
        bench, "FULL_PATH", str(tmp_path / "bench_full.json")
    )
    monkeypatch.setattr(bench, "bench_kriging", lambda: 0.5)
    monkeypatch.setattr(bench, "bench_ensemble", lambda: 0.1)
    monkeypatch.setattr(bench, "bench_vpu_micro", lambda: {"n": 4096})
    return bench


def _run_main(bench):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench.main()
    lines = [
        ln for ln in buf.getvalue().splitlines()
        if ln.strip().startswith("{")
    ]
    return [json.loads(ln) for ln in lines]  # every line must parse


def test_every_line_valid_and_incremental(bench_mod):
    docs = _run_main(bench_mod)
    # one line after each section (3) + final extras re-emit(s)
    assert len(docs) >= 3
    first, last = docs[0], docs[-1]
    # the FIRST line is already a valid headline artifact
    assert first["value"] == 0.5
    assert first["unit"] == "s"
    assert first["vs_baseline"] == pytest.approx(20.0)
    # later lines only ever gain keys
    for a, b in zip(docs, docs[1:]):
        assert set(a) <= set(b)
    assert last["ensemble_s"] == 0.1
    assert last["draws_per_sec"] == pytest.approx(1000.0)
    # context-only scalars ("n") are compacted off the printed line;
    # the FULL nested result must still land in bench_full.json
    assert last["vpu_microbench"] == {}
    with open(bench_mod.FULL_PATH) as f:
        full = json.load(f)
    assert full["vpu_microbench"] == {"n": 4096}
    # every printed line must fit the driver's tail-capture window
    assert all(
        len(json.dumps(d)) + 1 <= bench_mod.MAX_LINE_BYTES for d in docs
    )


def test_failed_section_degrades_to_skipped(bench_mod, monkeypatch):
    def boom():
        raise RuntimeError("device fault")

    monkeypatch.setattr(bench_mod, "bench_ensemble", boom)
    docs = _run_main(bench_mod)
    last = docs[-1]
    assert last["value"] == 0.5  # headline survives the failure
    # type-stable degradation: numeric field -> null, reason on a
    # sibling key (prior artifacts have numeric ensemble_s; a consumer
    # doing arithmetic must see null, not a dict)
    assert last["ensemble_s"] is None
    assert "RuntimeError" in last["ensemble_skipped"]


def test_budget_zero_skips_every_extra(bench_mod):
    last = _run_main(bench_mod)[-1]
    extras = [
        v for k, v in last.items()
        if isinstance(v, dict) and "skipped" in v
    ]
    assert extras, "budget=0 must mark the extras skipped, not drop them"
    assert all("budget" in v["skipped"] for v in extras)


def test_device_sections_fail_off_gpu(monkeypatch, tmp_path):
    """An unstubbed device section on the CPU records a failure naming
    the backend; it never times the CPU."""
    import bench

    monkeypatch.setenv("GLOMAR_BENCH_BUDGET_S", "0")
    monkeypatch.setattr(
        bench, "FULL_PATH", str(tmp_path / "bench_full.json")
    )
    monkeypatch.setattr(bench, "bench_kriging", lambda: 0.5)
    monkeypatch.setattr(bench, "bench_ensemble", lambda: 0.1)
    last = _run_main(bench)[-1]
    reason = last["vpu_microbench"]["skipped"]
    assert reason.startswith("RuntimeError")
    assert "needs a GPU" in reason
    with pytest.raises(RuntimeError, match="needs a GPU"):
        bench.bench_stream_clip()
