"""The metric readers, the byte counts of the kernel metrics, the result
line's keys, and a run that finds no card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from portbench import readers, roofline, run, trace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SMALL = {
    "jpeg-q85-grain-stream": {"traffic": {"batch": 2, "pool": 4, "images": {"width": 48, "height": 32, "objects": 5}},
                              "config": {"options": {"width": 48, "height": 32}, "host_workers": 2}},
    "thumb-jpeg768-to-128": {"traffic": {"files_per_call": 6, "pool": 3, "images": {"width": 48, "height": 32, "objects": 5}},
                             "config": {"thumb_size": 16, "chunk_size": 4, "host_workers": 2}},
}


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_byte_counts_equal_the_kernel_tables_rows():
    assert roofline.coeffs_bytes(16, 512, 512, "420") == 25_165_824
    assert roofline.resize_bytes(64, 256, 256, 3, 128, 128) == 15_728_640
    assert roofline.idct_bytes(98_304) == 18_874_368
    assert roofline.compact_bytes(98_304, 8) == 15_237_120
    assert roofline.blocks(512, 768, "420") == 9216 and roofline.blocks(128, 128, "444") == 768


def test_stage_bytes_count_the_pixels_in_and_the_routes_arrays_out():
    n = 64 * 9216
    assert roofline.encode_stage_bytes(64, 512, 768, "420", 32) == 64 * 512 * 768 * 3 + n * 99
    assert roofline.encode_stage_bytes(64, 512, 768, "420", "dense") == 64 * 512 * 768 * 3 + n * 128
    assert roofline.thumb_out_bytes(64, 128, 16) == 64 * 768 * 51


def test_every_metric_of_the_benchmark_has_a_reader_that_agrees_with_it():
    bench = _bench()
    for entry in bench["end_to_end"] + bench["per_layer"]:
        run._checked_reader(entry)


def _run(facts, tr=None):
    return readers.Run(setup_s=1.0, window_s=2.0, facts=facts, trace=tr)


def test_a_missing_stats_key_reads_null():
    stats_run = _run({"units": 3, "chunks": 16, "stats": [{"pack_iv": [(0.0, 0.5)]}]})
    assert run.load_metric("encode.pack_ms_per_batch").read(stats_run) == pytest.approx(500 / 3)
    for name in ("encode.copy_ms_per_batch", "thumb.decode_ms_per_chunk", "thumb.pack_ms_per_chunk"):
        assert run.load_metric(name).read(stats_run) is None
    assert run.load_metric("thumb.pack_ms_per_chunk").read(
        _run({"chunks": 16, "stats": [{"pack_s": 0.8}, {}]})) is None


def _trace(ops, t0=0.0, t1=1.0):
    tr = trace.DeviceTrace()
    tr.ops, tr.t0, tr.t1 = ops, t0, t1
    return tr


def test_an_unmatched_kernel_reads_null_and_a_matched_one_a_share():
    facts = {"stage_bytes": 3.35e9}
    other = _trace([("void some_other_kernel<1>(int)", 0.1, 0.2)])
    for name in ("encode.device_roofline_pct", "thumb.device_roofline_pct"):
        assert run.load_metric(name).read(_run(facts, other)) is None
        assert run.load_metric(name).read(_run(facts, None)) is None
    hit = _trace([("void coeffs_kernel<2>(unsigned char const*)", 0.1, 0.3),
                  ("compact_kernel(short const*, long)", 0.5, 0.6)])
    assert run.load_metric("encode.device_roofline_pct").read(_run(facts, hit)) == pytest.approx(100 * 1e-3 / 0.3)


def test_idle_share_and_gaps_from_the_union_of_device_operations():
    tr = _trace([("a", 0.1, 0.3), ("b", 0.2, 0.4), ("Memcpy HtoD", 0.7, 0.8)])
    assert tr.busy_s() == pytest.approx(0.4)
    assert run.load_metric("thumb.device_idle_pct").read(_run({}, tr)) == pytest.approx(60.0)
    gaps = tr.idle_gaps([("host pack", 0.4, 0.7)])
    assert gaps[0] == ["host pack", pytest.approx(0.3)] and len(gaps) == 3
    assert [g[0] for g in tr.idle_gaps()] == ["no span"] * 3
    assert run.load_metric("encode.device_idle_pct").read(_run({}, _trace([]))) is None


def test_the_streams_idle_gaps_are_named_by_its_own_stats():
    from portbench.drivers import jpeg_stream

    stats = {"dispatch_t": [0.0], "copy_iv": [(0.1, 0.2)], "pack_iv": [(0.2, 0.5), (0.6, 0.7)]}
    spans = jpeg_stream.spans(stats)
    assert spans == [("d2h copy stage", 0.1, 0.2), ("host pack", 0.2, 0.5), ("host pack", 0.6, 0.7)]
    assert trace.label(spans, 0.15, 0.45) == "host pack+d2h copy stage"
    assert trace.label(spans, 0.8, 0.9) == "no span" and jpeg_stream.spans({}) == []


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_result_line_carries_the_contracts_keys(cell):
    r = run.run_cell(cell, 2**31 + 3, 0.3, False, device="cpu", overrides=SMALL[cell])
    assert set(r) - {"work", "setup"} == {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert r["setup"]["build_s"] >= 0 and r["setup"]["setup_s"] == r["metrics"]["setup_s"]["value"]
    assert list(r)[-1] == "checks" and r["correct"] is True and r["failed"] == 0
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    names = {m["name"] for m in run.cell_metrics(_bench(), cell, False)}
    assert set(r["metrics"]) == names and "setup_s" in names
    assert all(set(m) >= {"value", "unit"} for m in r["metrics"].values())
    assert r["checks"] == {"mismatched_files": {"value": 0, "limit": 0}, "missing_files": {"value": 0, "limit": 0}}


def test_every_cell_reports_setup_an_end_to_end_and_a_per_layer_metric():
    bench = _bench()
    for cell in bench["workloads"]:
        e2e = {m["name"] for m in run.cell_metrics(bench, cell["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert run.cell_metrics(bench, cell["name"], True)


def test_a_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "jpeg-q85-grain-stream",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA card" in out.stderr


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the card, never the CPU in its place")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["thumb-jpeg768-to-128", "jpeg-q85-grain-stream"])
def test_a_short_run_on_the_card_is_correct(card, cell):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed", "2147483659",
                          "--seconds", "2", "--trace", "1"], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
