"""The comparison that decides ``correct`` fails what it must fail.

- The control: the reference put in the program's place, every float32
  step rounded to bfloat16, comes out not correct through a whole run and
  its own judge (``portbench/control.py``; on the card at the cells' own
  sizes, here at a small one).
- The faults a cell can have, planted under the timed path of a whole run
  on the CPU (the harness's look for a card skipped): an answer altered
  where it is produced, half a batch left out, and a stage that hands on
  its first state unchanged. Each run must come out not correct.
"""

from __future__ import annotations

import pytest

from portbench import control, run

_STREAM = {"traffic": {"batch": 2, "pool": 4, "images": {"width": 48, "height": 32, "objects": 5}},
           "config": {"options": {"width": 48, "height": 32}, "host_workers": 2}}
# (cell, overrides): the stream on the dense route (its cell), the stream
# on the padded route (the same cell's mix without grain: the photo mix,
# whose cell waits for a steadier host), and the thumbnail farm
CASES = {
    "grain-stream": ("jpeg-q85-grain-stream", _STREAM),
    "photo-stream": ("jpeg-q85-grain-stream",
                     {**_STREAM, "traffic": {**_STREAM["traffic"],
                                             "images": {**_STREAM["traffic"]["images"], "grain_sigma": 0}}}),
    "jpeg768": ("thumb-jpeg768-to-128",
                {"traffic": {"files_per_call": 6, "pool": 3, "images": {"width": 48, "height": 32, "objects": 5}},
                 "config": {"thumb_size": 16, "chunk_size": 4, "host_workers": 2}}),
}
NAMES = sorted(CASES)


@pytest.mark.parametrize("case", NAMES)
def test_the_sound_run_is_correct(case):
    cell, small = CASES[case]
    assert run.run_cell(cell, 21, 0.3, False, device="cpu", overrides=small)["correct"] is True


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 7])
@pytest.mark.parametrize("case", NAMES)
def test_the_bfloat16_control_is_not_correct(case, seed):
    """The bfloat16 reference in the program's place, judged by the run's
    own comparison, comes out not correct, with every source it served."""
    cell, small = CASES[case]
    r = control.control(cell, seed, 0.05, device="cpu", overrides=small)
    assert r["correct"] is False and r["checks"]["mismatched_files"]["value"] > 0
    assert r["checks"]["missing_files"]["value"] == 0 and r["work"]["compared_files"] > 0


def _altered(monkeypatch):
    from pixo_tpu_torch.parallel import pipeline

    real = pipeline._assemble_jpeg
    calls = []

    def assemble(scan, *args, **kwargs):
        calls.append(1)
        out = real(scan, *args, **kwargs)
        if len(calls) == 7:  # one file, where the frame is made
            out = out[:-3] + bytes([out[-3] ^ 1]) + out[-2:]
        return out

    monkeypatch.setattr(pipeline, "_assemble_jpeg", assemble)


def _half_left_out(monkeypatch):
    from pixo_tpu_torch.parallel import pipeline

    real = pipeline._pack_hosted

    def pack(state, *args, **kwargs):
        scans = real(state, *args, **kwargs)
        return scans[: (len(scans) + 1) // 2]

    monkeypatch.setattr(pipeline, "_pack_hosted", pack)


def _unchanged(monkeypatch):
    from pixo_tpu_torch.parallel import pipeline

    real = pipeline._fetch
    first = []

    def fetch(shard, stream=None):
        got = real(shard, stream)
        if not first:
            first.append(got)
        return first[0]

    monkeypatch.setattr(pipeline, "_fetch", fetch)


@pytest.mark.parametrize("fault", [_altered, _half_left_out, _unchanged])
@pytest.mark.parametrize("case", NAMES)
def test_a_planted_fault_is_not_correct(case, fault, monkeypatch):
    cell, small = CASES[case]
    fault(monkeypatch)
    r = run.run_cell(cell, 22, 0.3, False, device="cpu", overrides=small)
    assert r["correct"] is False and r["failed"] > 0
