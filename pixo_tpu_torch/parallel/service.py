"""Compression service: a process pool with the operational contract of the
reference's web worker RPC (``web/src/lib/compress-client.ts:1-117`` and
``compress.worker.ts``).

Counterpart of the JAX package's ``parallel/service.py``, with the same
contract:

- ``CompressService.submit_png/submit_jpeg/submit_resize`` return a request
  handle with an id (the postMessage id analog);
- a per-request deadline, 120 s by default (``REQUEST_TIMEOUT_MS``);
- ``cancel(request)``: a pending request is dropped, an in-flight one's
  result is discarded on arrival (the cancellation-set semantics);
- a worker that dies rejects every pending request with ``WorkerCrashed``
  and the pool is spawned again (``compress-client.ts:52-60``).

The workers run the port's encoders on ``device``: ``jpeg.encode`` (a batch
of one through the coefficient and compaction kernels on a card),
``png.encode`` and ``resize.resize`` (the resize kernel on a card). Each
worker is a process of its own, started with ``spawn``: a process forked
from one that touched CUDA cannot use CUDA, and forking a threaded process
can copy held locks into the child. A worker makes its own CUDA context at
its first request on a card (a respawned worker a new one), builds or loads
the kernel library (cold workers building at once serialize on the build
directory's lock file, ``utils/build.py``), and with ``device="cpu"`` never
initializes CUDA. Requests and results cross the process boundary as
``bytes`` and numpy arrays, never as CUDA tensors.
"""

from __future__ import annotations

import concurrent.futures
import itertools
import multiprocessing
import threading
import time
from concurrent.futures.process import BrokenProcessPool
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np


def _worker_init() -> None:
    """Runs first in each spawned worker: the port's import (torch's, cold),
    before the worker's first task. It touches nothing of CUDA."""
    import pixo_tpu_torch  # noqa: F401


class RequestTimeout(Exception):
    """The request exceeded its deadline (client-side reject, like the
    reference's 120 s timer; the worker's eventual result is dropped)."""


class RequestCancelled(Exception):
    """The request was cancelled before completion."""


class WorkerCrashed(Exception):
    """A worker process died; all requests pending at crash time are
    rejected with this error and the pool is respawned."""


def _encode_png_task(img: np.ndarray, options, device: str) -> bytes:
    from ..png import encoder as penc

    return penc.encode(img, options, device=device)


def _encode_jpeg_task(img: np.ndarray, options, device: str) -> bytes:
    from ..jpeg import encoder as jenc

    return jenc.encode(img, options, device=device)


def _resize_task(img: np.ndarray, options, device: str) -> np.ndarray:
    from ..resize import resize as do_resize

    return do_resize(img, options, device=device)


@dataclass
class Request:
    """Handle for one submitted compression request."""

    id: int
    deadline: float
    _future: concurrent.futures.Future = field(repr=False)
    _service: "CompressService" = field(repr=False)

    def result(self, timeout: Optional[float] = None) -> Any:
        """Block for the result, honoring the request deadline."""
        budget = self.deadline - time.monotonic()
        if timeout is not None:
            budget = min(budget, timeout)
        try:
            return self._future.result(timeout=max(budget, 0.0))
        except concurrent.futures.TimeoutError:
            self._service.cancel(self)
            raise RequestTimeout(f"request {self.id} timed out") from None
        except concurrent.futures.CancelledError:
            raise RequestCancelled(f"request {self.id} cancelled") from None
        except BrokenProcessPool:
            raise WorkerCrashed(f"worker died while serving request {self.id}") from None

    def done(self) -> bool:
        return self._future.done()


class CompressService:
    """Process-pool compression service with the reference front-end's
    operational contract (ids, timeout, cancellation, crash recovery); the
    workers compute on ``device`` ("cuda" or "cpu")."""

    def __init__(self, workers: int = 2, timeout_s: float = 120.0, *, device="cuda"):
        self._workers = workers
        self._timeout_s = timeout_s
        self._device = str(device)
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._pending: dict = {}  # id -> Request
        self._pool = self._spawn()

    def _spawn(self):
        return concurrent.futures.ProcessPoolExecutor(
            max_workers=self._workers,
            mp_context=multiprocessing.get_context("spawn"),
            initializer=_worker_init,
        )

    # -- submission ---------------------------------------------------------

    def _submit(self, fn, *args, timeout: Optional[float] = None) -> Request:
        deadline = time.monotonic() + (timeout if timeout is not None else self._timeout_s)
        with self._lock:
            try:
                fut = self._pool.submit(fn, *args)
            except BrokenProcessPool:
                self._recover_locked()
                fut = self._pool.submit(fn, *args)
            req = Request(id=next(self._ids), deadline=deadline, _future=fut, _service=self)
            self._pending[req.id] = req
            fut.add_done_callback(lambda f, rid=req.id: self._on_done(rid, f))
        return req

    def submit_png(self, img, options, timeout: Optional[float] = None) -> Request:
        return self._submit(_encode_png_task, np.asarray(img), options, self._device, timeout=timeout)

    def submit_jpeg(self, img, options, timeout: Optional[float] = None) -> Request:
        return self._submit(_encode_jpeg_task, np.asarray(img), options, self._device, timeout=timeout)

    def submit_resize(self, img, options, timeout: Optional[float] = None) -> Request:
        return self._submit(_resize_task, np.asarray(img), options, self._device, timeout=timeout)

    def submit_raw(self, fn, *args, timeout: Optional[float] = None) -> Request:
        """Run an arbitrary picklable callable in a worker (test hook and
        escape hatch, like the worker's generic message dispatch); it gets
        no ``device`` of its own."""
        return self._submit(fn, *args, timeout=timeout)

    # -- lifecycle ----------------------------------------------------------

    def _on_done(self, rid: int, fut: concurrent.futures.Future) -> None:
        with self._lock:
            self._pending.pop(rid, None)
        exc = fut.exception() if not fut.cancelled() else None
        if isinstance(exc, BrokenProcessPool):
            self._handle_crash()

    def cancel(self, req: Request) -> bool:
        """Drop a request: pending ones are cancelled outright; in-flight
        results are discarded when they arrive (cancellation-set
        semantics — the worker cannot be interrupted mid-encode)."""
        with self._lock:
            self._pending.pop(req.id, None)
        return req._future.cancel()

    def _handle_crash(self) -> None:
        with self._lock:
            self._recover_locked()

    def _recover_locked(self) -> None:
        """Reject all pending requests and respawn the pool
        (``compress-client.ts:52-60`` worker-crash behavior)."""
        stale = list(self._pending.values())
        self._pending.clear()
        for req in stale:
            if not req._future.done():
                req._future.cancel()
        old = self._pool
        self._pool = self._spawn()
        # Tear the broken pool down off-thread: this method can run on the
        # old pool's own management thread (future done-callbacks fire
        # inside its _terminate_broken, which holds executor locks that
        # shutdown() would need; calling it here deadlocks).
        threading.Thread(target=lambda: old.shutdown(wait=False, cancel_futures=True),
                         daemon=True).start()

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def close(self) -> None:
        self._pool.shutdown(wait=True, cancel_futures=True)

    def __enter__(self) -> "CompressService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
