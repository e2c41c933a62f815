"""Device meshes: a 1D arrangement of torch devices and the batch's split
over it.

Counterpart of the JAX package's ``parallel/mesh.py``. A JAX ``Mesh`` places
one array's shards on its devices and XLA runs the step on each; here a mesh
is the ordered list of devices, and ``batch_sharding(mesh).ranges(b)`` says
which contiguous images of a batch of ``b`` each device takes. The pipelines
that take ``mesh=`` (``jpeg_coeffs_sharded``, ``encode_jpeg_batch_sharded``
and the two streams) run each shard's device stage on its device; images
are independent, so the files are those of one device whatever the split.
``make_mesh(8, device="cpu")`` is the analog of the JAX tests' 8 virtual CPU
devices.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch


class _Unset(str):
    """The type of ``DEFAULT_DEVICE``: a ``device`` the caller did not give."""


# The default of every ``device`` keyword that sits beside ``mesh=``: equal
# to "cuda", and told apart from an explicit "cuda" by identity.
DEFAULT_DEVICE = _Unset("cuda")


class Mesh(NamedTuple):
    """A 1D mesh: ``devices`` in order along the axis ``axis_names[0]``."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


class NamedSharding(NamedTuple):
    """How an array with a leading batch axis lies on ``mesh``: ``spec``
    ``(axis,)`` splits that axis over the mesh's devices, ``()`` gives every
    device all of it."""

    mesh: Mesh
    spec: Tuple[str, ...]

    def ranges(self, b: int) -> List[Tuple[torch.device, int, int]]:
        """(device, lo, hi) for each device that holds images of a batch of
        ``b``: split, contiguous shards of sizes that differ by at most one,
        in the mesh's order (a device left without images is left out);
        replicated, [0, b) on every device."""
        devices = self.mesh.devices
        if not self.spec:
            return [(d, 0, b) for d in devices]
        n = len(devices)
        cuts = [k * b // n for k in range(n + 1)]
        return [(d, lo, hi) for d, lo, hi in zip(devices, cuts, cuts[1:]) if hi > lo]


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "batch", *,
              device="cuda") -> Mesh:
    """1D mesh over the first ``n_devices`` CUDA devices (default: all), or
    with ``device="cpu"`` over ``n_devices`` entries of the CPU device
    (default: one)."""
    kind = torch.device(device).type
    if kind == "cpu":
        n = 1 if n_devices is None else n_devices
        devices = (torch.device("cpu"),) * n
    elif kind == "cuda":
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if n > count:
            raise ValueError(f"a mesh of {n} CUDA devices asked for, {count} visible")
        devices = tuple(torch.device("cuda", i) for i in range(n))
    else:
        raise ValueError(f"unsupported device {device!r}")
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, got {n}")
    return Mesh(devices, (axis_name,))


def batch_sharding(mesh: Mesh, axis_name: str = "batch") -> NamedSharding:
    """Shard the leading (batch) dimension across the mesh."""
    return NamedSharding(mesh, (axis_name,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def placement(mesh: Optional[Mesh], device, b: int) -> List[Tuple[torch.device, int, int]]:
    """(device, lo, hi) shards of a batch of ``b`` images: the whole batch on
    ``device`` without a mesh, else ``batch_sharding(mesh)``'s split. A mesh
    together with an explicit ``device`` raises."""
    if mesh is None:
        return [(torch.device(device), 0, b)]
    if device is not DEFAULT_DEVICE:
        raise ValueError("give mesh= or device=, not both")
    return batch_sharding(mesh).ranges(b)
