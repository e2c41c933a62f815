"""Two processes, one batch: the port's analog of ``tests/test_dcn.py``.

Two OS processes, joined by ``torch.distributed`` over gloo
(``tcp://127.0.0.1:<free port>``), take a batch of 8 64x64 gradient images
(those of ``tests/support/dcn_payload.py``) half each. Each process encodes
its 4 through ``encode_jpeg_batch_sharded`` at q85 4:4:4 and
``all_gather_object``s the files, which must equal one process's
``jpeg.encode_batch`` of all 8, byte for byte; then it ``all_reduce``s an
int64 digest of its coefficients, which must equal the digest of the whole
batch computed locally (and differ from its own half's): the collective
crossed the process boundary. A pair that does not finish within its
timeout fails the test.

Run alone, the file is one process's payload:

    python tests/test_torch_dcn.py RANK PORT [DEVICE]

(``DEVICE`` "cpu" by default; ``chip_smoke.py`` runs both ranks on
"cuda:0" with gloo, since NCCL does not put two ranks on one card).
"""

import os
import socket
import subprocess
import sys

import pytest

WORLD = 2
PER_RANK = 4
SIZE = 64
QUALITY = 85
PAIR_TIMEOUT = 300  # seconds both processes get, start-up included


def images():
    """The 8 [64, 64, 3] uint8 gradients every process builds alike."""
    import numpy as np

    yy, xx = np.meshgrid(np.arange(SIZE), np.arange(SIZE), indexing="ij")
    base = np.clip(np.stack([xx * 3, yy * 4, xx + yy], -1), 0, 255).astype(np.uint8)
    return np.stack([np.roll(base, 5 * i, axis=1) for i in range(WORLD * PER_RANK)])


def digest(zz) -> int:
    """Sum of the int16 coefficients weighted by their zigzag index + 1, in int64."""
    import numpy as np

    return int((np.asarray(zz, np.int64) * (np.arange(64, dtype=np.int64) + 1)).sum())


def payload(rank: int, port: int, device: str) -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from datetime import timedelta

    import numpy as np
    import torch
    import torch.distributed as dist

    from pixo_tpu_torch import ColorType, JpegOptions, Subsampling, encode_jpeg_batch_sharded, jpeg
    from pixo_tpu_torch.jpeg.encoder import compute_coefficients_host
    from pixo_tpu_torch.jpeg.tables import QuantizationTables
    from pixo_tpu_torch.parallel.pipeline import jpeg_coeffs_sharded

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=WORLD, rank=rank,
                            timeout=timedelta(seconds=PAIR_TIMEOUT))
    try:
        imgs = images()
        opts = JpegOptions(width=SIZE, height=SIZE, quality=QUALITY, color_type=ColorType.RGB,
                           subsampling=Subsampling.S444)
        local = imgs[rank * PER_RANK:(rank + 1) * PER_RANK]
        files = encode_jpeg_batch_sharded(local, opts, device=device)
        gathered = [None] * WORLD
        dist.all_gather_object(gathered, files)
        got = [f for part in gathered for f in part]
        assert got == jpeg.encode_batch(imgs, opts, device=device), "gathered files != one process's"

        zz = jpeg_coeffs_sharded(local, opts, device=device).cpu().numpy()
        total = torch.tensor([digest(zz)], dtype=torch.int64)
        dist.all_reduce(total)
        quant = QuantizationTables(QUALITY)
        want = digest(np.stack([compute_coefficients_host(im, opts, quant) for im in imgs]))
        assert int(total[0]) == want, f"all-reduced digest {int(total[0])} != local {want}"
        assert digest(zz) != want, "one process's half already gives the whole digest"
        print(f"DCN-OK {rank} {device} {len(got)} files, digest {want}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_pair(device: str = "cpu", timeout: float = PAIR_TIMEOUT) -> list:
    """Run the payload as ranks 0 and 1 on ``device``; their outputs. Raises
    ``AssertionError`` where a process fails, prints no OK line, or the pair
    outlives ``timeout`` (both are then killed)."""
    port = free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(rank), str(port), device],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise AssertionError(f"the two processes did not finish within {timeout} s")
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {rank} failed ({p.returncode}):\n{out}"
        assert f"DCN-OK {rank}" in out, f"process {rank} printed no OK line:\n{out}"
    return outs


@pytest.mark.dcn
def test_two_process_batch_sharding_byte_identical():
    outs = run_pair("cpu")
    assert all("8 files" in out for out in outs)


if __name__ == "__main__":
    sys.exit(payload(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3] if len(sys.argv) > 3 else "cpu"))
