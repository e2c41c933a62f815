"""Build shared libraries from the checkout's sources at first use.

Both native libraries of the port (the C++ host tier and the CUDA kernels)
are compiled by this helper into ``pixo_tpu_torch/_build/``, named by a
digest of the compiler command, the sources and a caller's key (the host
CPU, for a ``-march=native`` build), so a changed source, flag or CPU builds
anew and an unchanged one loads the library already built. Concurrent
processes (test workers) serialize on a lock file; the library is written
under a temporary name and renamed into place. Given a link command, each
source is compiled to an object of its own, all at once, and the objects are
then linked: the CUDA kernels build in the time of their slowest source.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional, Sequence

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")


class Built(NamedTuple):
    path: str
    seconds: float  # time spent compiling; 0.0 when the library was already built
    log: str  # the compiler's output; empty when the library was already built


def _run(name: str, cmd: Sequence[str], timeout: float) -> str:
    """Run one compiler command; its output, or ``RuntimeError`` with it."""
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building lib{name} failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"building lib{name} failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    return proc.stdout + proc.stderr


def build_shared_library(
    name: str,
    command: Sequence[str],
    sources: Sequence[str],
    timeout: float,
    key: str = "",
    link: Optional[Sequence[str]] = None,
) -> Built:
    """Compile ``sources`` into ``_build/lib<name>-<digest>.so``; ``key``
    enters the digest too.

    Without ``link``, one call of ``command`` (the compiler and its flags, to
    which ``-o <library>`` and the sources are appended) builds the library.
    With ``link``, ``command -c -o <object> <source>`` runs for every source
    at once, and ``link -o <library> <objects>`` joins them. Headers
    (``.h``, ``.cuh``) enter the digest and are not compiled.

    Raises ``RuntimeError`` with the compiler's output on failure.
    """
    parts = [*command, "\1", *link, key] if link is not None else [*command, key]
    digest = hashlib.sha256("\0".join(parts).encode())
    for src in sources:
        with open(src, "rb") as f:
            digest.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return Built(path, 0.0, "")
    with open(os.path.join(BUILD_DIR, f".{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            return Built(path, 0.0, "")
        tmp = f"{path}.{os.getpid()}.tmp"
        compiled = [s for s in sources if not s.endswith((".h", ".cuh"))]
        t0 = time.perf_counter()
        if link is None:
            log = _run(name, [*command, "-o", tmp, *compiled], timeout)
        else:
            objects = [f"{tmp}.{i}.o" for i in range(len(compiled))]
            try:
                with ThreadPoolExecutor(max_workers=len(compiled)) as ex:
                    logs = list(ex.map(
                        lambda so: _run(name, [*command, "-c", "-o", so[1], so[0]], timeout),
                        zip(compiled, objects),
                    ))
                log = "".join(logs) + _run(name, [*link, "-o", tmp, *objects], timeout)
            finally:
                for obj in objects:
                    if os.path.exists(obj):
                        os.remove(obj)
        os.replace(tmp, path)
        return Built(path, time.perf_counter() - t0, log)
