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

Given a ``Training``, the build is profile-guided, in three steps under the
one lock: an instrumented compile (``-fprofile-generate``), the training
command run in a subprocess on that library, and a compile that reads the
profile (``-fprofile-use``). GCC names the profile file after the compile's
output path, so both compiles write the same temporary name; the final
compile must find the profile, or the build raises. The bytes of the
training's files enter the digest (its command, which names the
interpreter, does not), so a plain and a profile-guided library of one
source sit side by side.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, NamedTuple, Optional, Sequence

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")

# the instrumented library's counters are atomic: the library runs its own
# threads (the trellis DP, the batch packers), which would race plain ones
PROFILE_GENERATE = ("-fprofile-update=atomic",)
PROFILE_USE = ("-fprofile-correction",)
MISSING_PROFILE = "profile count data file not found"  # GCC's -Wmissing-profile, on by default


class Training(NamedTuple):
    """A profile-guided build's training: ``command`` with the instrumented
    library's path appended, run in ``cwd``; ``files`` (the trainer's
    sources) enter the library's digest."""
    command: Sequence[str]
    files: Sequence[str]
    cwd: str


class Built(NamedTuple):
    path: str
    seconds: float  # time spent building; 0.0 when the library was already built
    log: str  # the compiler's output; empty when the library was already built
    steps: Dict[str, float] = {}  # each step's seconds; empty when the library was already built


def _run(name: str, cmd: Sequence[str], timeout: float, cwd: Optional[str] = None) -> str:
    """Run one build command; its output, or ``RuntimeError`` with it."""
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, cwd=cwd)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building lib{name} failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"building lib{name} failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    return proc.stdout + proc.stderr


def _profile_guided(name: str, command: Sequence[str], compiled: Sequence[str], out: str,
                    training: Training, profile_dir: str, timeout: float) -> tuple:
    """The three steps of a profile-guided build of ``compiled`` into ``out``:
    (the compilers' and the trainer's output, each step's seconds)."""
    shutil.rmtree(profile_dir, ignore_errors=True)  # a killed build's counts would add up
    logs = []
    try:
        t0 = time.perf_counter()
        logs.append(_run(name, [*command, f"-fprofile-generate={profile_dir}", *PROFILE_GENERATE,
                                "-o", out, *compiled], timeout))
        t1 = time.perf_counter()
        logs.append(_run(name, [*training.command, out], timeout, cwd=training.cwd))
        t2 = time.perf_counter()
        final = _run(name, [*command, f"-fprofile-use={profile_dir}", *PROFILE_USE,
                            "-o", out, *compiled], timeout)
        t3 = time.perf_counter()
    finally:
        shutil.rmtree(profile_dir, ignore_errors=True)
    if MISSING_PROFILE in final:
        raise RuntimeError(f"building lib{name} failed: the final compile found no profile\n{final}")
    steps = {"instrumented compile": t1 - t0, "training": t2 - t1, "final compile": t3 - t2}
    return "".join(logs) + final, steps


def library_path(name: str, command: Sequence[str], sources: Sequence[str], key: str = "",
                 link: Optional[Sequence[str]] = None, training: Optional[Training] = None) -> str:
    """``_build/lib<name>-<digest>.so``: where ``build_shared_library``
    builds the library of these arguments."""
    parts = [*command, "\1", *link, key] if link is not None else [*command, key]
    if training is not None:
        parts += ["\2", *PROFILE_GENERATE, *PROFILE_USE]
    digest = hashlib.sha256("\0".join(parts).encode())
    for src in [*sources, *(training.files if training is not None else ())]:
        with open(src, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build_shared_library(
    name: str,
    command: Sequence[str],
    sources: Sequence[str],
    timeout: float,
    key: str = "",
    link: Optional[Sequence[str]] = None,
    training: Optional[Training] = None,
) -> Built:
    """Compile ``sources`` into ``library_path(...)``, named by a digest of
    the arguments but ``timeout``.

    Without ``link``, one call of ``command`` (the compiler and its flags, to
    which ``-o <library>`` and the sources are appended) builds the library;
    with ``training`` too, three steps do (the module's docstring). With
    ``link``, ``command -c -o <object> <source>`` runs for every source at
    once, and ``link -o <library> <objects>`` joins them. Headers (``.h``,
    ``.cuh``) enter the digest and are not compiled.

    Raises ``RuntimeError`` with the compiler's or the trainer's output on
    failure.
    """
    if link is not None and training is not None:
        raise ValueError("a profile-guided build compiles and links in one command")
    path = library_path(name, command, sources, key, link, training)
    os.makedirs(BUILD_DIR, exist_ok=True)
    if os.path.exists(path):
        return Built(path, 0.0, "")
    with open(os.path.join(BUILD_DIR, f".{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            return Built(path, 0.0, "")
        tmp = f"{path}.tmp"  # one fixed name under the lock: the profile's name follows it
        compiled = [s for s in sources if not s.endswith((".h", ".cuh"))]
        t0 = time.perf_counter()
        if training is not None:
            log, steps = _profile_guided(name, command, compiled, tmp, training, f"{path}.profile",
                                         timeout)
        elif link is None:
            log = _run(name, [*command, "-o", tmp, *compiled], timeout)
            steps = {"compile": time.perf_counter() - t0}
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
            steps = {"compile": time.perf_counter() - t0}
        os.replace(tmp, path)
        return Built(path, time.perf_counter() - t0, log, steps)
