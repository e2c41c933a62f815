"""The control of the comparison that decides ``correct``: the reference put
in the program's place, computed a precision below the one the codec
states, must come out not correct.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] [--seconds <s>]

For each seed it makes a whole run of the cell (``run.run_cell``) in which
the entry the window drives hands out, for every source, what the
reference works out with every float32 step rounded to bfloat16 (the
chroma averages, the DCT, the quantizer's division and the resize's sums),
worked out once a source in set-up at the cell's own sizes. The run's own
judge compares those outputs with the float32 reference after the window,
as it compares the program's. The control's outputs come without the
program's work, so a short window (``--seconds``, 0.2 by default) already
compares more files than a run of the program does. It prints each run's
numbers beside their limits and, last, one JSON object with each seed's
``correct`` and numbers. The benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != os.path.dirname(__file__)]
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bf16(t):
    """Round a float32 tensor to bfloat16 and back."""
    import torch

    return t.to(torch.bfloat16).to(torch.float32)


def control(workload: str, seed: int, seconds: float = 0.2, device="cuda", overrides=None) -> dict:
    """A run of ``workload`` with the bfloat16 reference in the program's
    place: ``run.run_cell``'s result, whose ``correct`` must be false."""
    from portbench import run

    def low_precision(cell):
        cell.stand_in(cell.reference(device, rnd=bf16)[0])

    t0 = time.perf_counter()
    result = run.run_cell(workload, seed, seconds, False, device=device, overrides=overrides,
                          started=t0, prepare=low_precision)
    result["seconds"] = time.perf_counter() - t0
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=0.2)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench control: needs a CUDA card", file=sys.stderr)
        return 2
    out = []
    for seed in args.seeds:
        r = control(args.workload, seed, args.seconds)
        numbers = ", ".join(f"{k} {c['value']} (limit {c['limit']})" for k, c in r["checks"].items())
        print(f"control {args.workload} seed {seed}: correct {r['correct']}; {numbers}; "
              f"{r['work']['compared_files']} files compared, {r['seconds']:.1f} s", flush=True)
        out.append({"seed": seed, "correct": r["correct"], "checks": r["checks"],
                    "compared_files": r["work"]["compared_files"], "attempted": r["attempted"]})
    print(json.dumps({"workload": args.workload, "device": torch.cuda.get_device_name(0),
                      "controls": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
