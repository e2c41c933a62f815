"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(``python3 -m portbench.run`` does the same.) The cell names its
configuration and its traffic mix; each lives in a file of its own
(``portbench/configs/<config>.json``, ``portbench/traffic/<traffic>.json``),
and each metric in ``portbench/metrics/<metric>.py``, so a cell, a mix or a
metric is added with new files and new ``BENCHMARK.json`` entries alone.

A run: makes its inputs from the seed; warms the cell's shapes through the
timed entry; keeps handing it whole units of work until ``--seconds`` have
passed and lets the unit in flight finish (the window; with ``--trace 1``
under the profiler); then reads the card's peak memory, frees the
program's state, works every output out again with the plain reference
(``portbench/reference``) and compares them byte for byte. The last line
of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the end-to-end metrics, or with ``--trace 1`` the
per-layer ones), ``device`` and, traced, ``breakdown``; then ``checks``,
each number compared with its limit, which also end standard error.
Beside them ``setup`` says how much of ``setup_s`` built the program (a
checkout's first run builds it), and ``work`` what the window did.

It needs a CUDA card: without one, or with fewer than the cell asks for,
it exits 2 and prints no result. It exits 3 and prints no result where the
process has loaded JAX, flax or the JAX package.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # the process's start, as near as Python sees it

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __package__ in (None, ""):  # run as a script: the checkout's root on the path, not portbench/
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != os.path.dirname(__file__)]
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "pixo_tpu")  # top-level module names, compared whole
LIMITS = {"mismatched_files": 0, "missing_files": 0}  # exact comparison: none may differ or lack


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _find(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"portbench: no {what} named {name!r} in BENCHMARK.json")


def load_metric(name: str):
    """The reader module of metric ``name`` (``portbench/metrics/<name>.py``)."""
    path = os.path.join(ROOT, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(bench: dict, cell: str, traced: bool) -> list:
    """The metric entries a cell reports: its end-to-end metrics, or traced
    its per-layer ones; an entry without ``workloads`` holds for every cell
    that reports what it moves."""
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in moved)]


def _checked_reader(entry: dict):
    reader = load_metric(entry["name"])
    said = {"unit": reader.UNIT, "source": reader.SOURCE}
    if hasattr(reader, "LAYER"):
        said.update(layer=reader.LAYER, moves=reader.MOVES)
    wrong = {k: v for k, v in said.items() if entry.get(k) != v}
    if wrong:
        raise SystemExit(f"portbench: metric {entry['name']} says {wrong}, BENCHMARK.json otherwise")
    return reader


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def build_seconds() -> float:
    """The seconds this process spent building the kernels and the host
    library (0 where it loaded them built)."""
    from pixo_tpu_torch import native
    from pixo_tpu_torch.ops import kernels

    return float(kernels.build_seconds) + float(sum(native.build_seconds.values()))


def load_cell(workload: str, overrides: Optional[dict] = None):
    """(BENCHMARK.json, the cell's configuration, its traffic mix), read from
    their files; ``overrides`` ({"traffic": {...}, "config": {...}}: keys
    replaced, a dict value merged one level down) let the tests shrink a
    cell."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = _find(bench["workloads"], workload, "workload")
    with open(os.path.join(ROOT, _find(bench["configs"], cell["config"], "configuration")["file"])) as f:
        config = json.load(f)
    with open(os.path.join(ROOT, "portbench", "traffic", f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    for part, spec in (("traffic", traffic), ("config", config)):
        for key, value in (overrides or {}).get(part, {}).items():
            spec[key] = {**spec[key], **value} if isinstance(value, dict) else value
    return bench, config, traffic


def _fifths(ends, window_s) -> list:
    """How many units ended in each fifth of the window."""
    bins = [0] * 5
    for t in ends:
        bins[min(4, max(0, int(5 * t / window_s)))] += 1
    return bins


def run_cell(workload: str, seed: int, seconds: float, traced: bool, device="cuda",
             overrides: Optional[dict] = None, started: float = T0, prepare=None) -> dict:
    """One run of ``workload``: the result line's object (the module's
    docstring). ``device`` and ``overrides`` (``load_cell``) let the tests
    drive a run on the CPU at a small size; ``prepare(cell)``, called on the
    driver's cell before its warm-up, lets the control put the reference in
    the program's place (``portbench/control.py``)."""
    import torch

    from portbench import readers
    from portbench import trace as tracing

    bench, config, traffic = load_cell(workload, overrides)
    entries = cell_metrics(bench, workload, traced)
    metric_readers = {e["name"]: _checked_reader(e) for e in entries}
    driver = importlib.import_module(f"portbench.drivers.{config['driver']}")
    on_card = torch.device(device).type == "cuda"

    state = driver.Cell(config, traffic, seed, device)
    if prepare is not None:
        prepare(state)
    state.warm()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - started

    before = resource.getrusage(resource.RUSAGE_SELF)
    with (tracing.DeviceTrace() if traced else contextlib.nullcontext()) as tr:
        rec = state.window(seconds)
    after = resource.getrusage(resource.RUSAGE_SELF)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    state.release()

    expected = state.reference(device)
    checks = state.judge(rec, expected)
    run = readers.Run(setup_s, rec.window_s, state.facts(rec, expected), tr)
    metrics = {}
    for e in entries:
        value = metric_readers[e["name"]].read(run)
        if value is None:
            print(f"portbench: metric {e['name']} found nothing to read: left out", file=sys.stderr)
            continue
        metrics[e["name"]] = {"value": value, "unit": e["unit"]}
        if hasattr(metric_readers[e["name"]], "count"):  # the samples a statistic is taken over
            metrics[e["name"]]["n"] = metric_readers[e["name"]].count(run)

    compared = {k: {"value": v, "limit": LIMITS[k]} for k, v in checks.items() if k in LIMITS}
    failed = checks["mismatched_files"] + checks["missing_files"]
    result = {
        "correct": all(c["value"] <= c["limit"] for c in compared.values()),
        "attempted": run.facts["images"] + checks["missing_files"],
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": 1 if on_card else 0,
            "memory_peak_bytes": peak,
            "power_limit_w": power_limit_w() if on_card else None,
        },
        # the part of setup_s that built the program: a checkout's first run
        # builds the kernels and the host library, later runs load them
        "setup": {"setup_s": setup_s, "build_s": build_seconds()},
        "work": {"units": run.facts["units"], "routes": [str(r) for r in run.facts["routes"]],
                 "compared_files": checks["compared_files"], "window_s": rec.window_s,
                 # the process's CPU seconds in the window
                 "cpu_s": after.ru_utime + after.ru_stime - before.ru_utime - before.ru_stime,
                 # units finished in each fifth of the window: a run that slows part-way shows
                 "fifths": _fifths(run.facts["unit_end_s"], rec.window_s)},
    }
    if traced:
        result["device"].update(busy_s=tr.busy_s() if tr.ops else 0.0, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps(run.facts.get("spans", ()))}
    result["checks"] = compared
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        chips = _find(json.load(f)["workloads"], args.workload, "workload")["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: the process loaded {', '.join(loaded)}: no result", file=sys.stderr)
        return 3
    print(f"setup: {result['setup']['setup_s']} s, of which {result['setup']['build_s']} s "
          "built the program", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
