"""Device meshes: a grid of torch devices with named axes, one stream per
position — the port of ``repro.launch.mesh``.

One Python process drives every position of a mesh, as the JAX package's
single-controller ``shard_map`` does: a :class:`Mesh` is a grid of
``torch.device``\\ s with named axes, and on CUDA each position carries its
own ``torch.cuda.Stream``, made once here, when the mesh is built — never
inside a launch.  ``torch.distributed`` and NCCL are not used.

A mesh's positions may repeat a device.  torch has no counterpart of
``--xla_force_host_platform_device_count``, so ``devices=`` is how a mesh
larger than the machine's device count is built: ``["cpu"]`` (every
position the CPU) on a host, ``[torch.device("cuda:0")] * 4`` on one card,
where the positions are four streams of the same GPU.  A position holds
nothing but its device and its stream, so a 256-position mesh of one
device costs 256 streams on a card and nothing on the CPU.

Mesh shapes (the reference's TPU v5e pods; the LM partitioning rules of
``distributed.partitioning`` resolve against them):
  single pod : (data=16, model=16)           = 256 positions
  multi-pod  : (pod=2, data=16, model=16)    = 512 positions
The SR serving mesh is ``(replica, bands)`` (:func:`make_sr_mesh`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

__all__ = [
    "Mesh",
    "SRMesh",
    "make_mesh",
    "make_production_mesh",
    "make_sr_mesh",
    "band_submesh",
    "SR_REPLICA_AXIS",
    "SR_BAND_AXIS",
    "SINGLE_POD",
    "MULTI_POD",
]

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))

# SR serving mesh axes: ``replica`` is pure data parallelism (whole frames,
# no communication), ``bands`` splits each frame's row bands spatially
# (L-row halo exchange at shard edges).
SR_REPLICA_AXIS = "replica"
SR_BAND_AXIS = "bands"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A grid of devices with named axes, stored row-major.

    ``devices[i]`` and ``streams[i]`` belong to flat position ``i``;
    ``streams[i]`` is ``None`` on a CPU position.
    """

    devices: Tuple[torch.device, ...]
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    streams: Tuple[Optional["torch.cuda.Stream"], ...]

    def __post_init__(self) -> None:
        size = 1
        for n in self.shape:
            size *= n
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} vs axes {self.axis_names}")
        if len(self.devices) != size or len(self.streams) != size:
            raise ValueError(
                f"mesh shape {self.shape} needs {size} positions, got "
                f"{len(self.devices)} devices and {len(self.streams)} streams"
            )

    @property
    def axis_sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct_devices(self) -> Tuple[torch.device, ...]:
        """The mesh's devices, each once, in position order."""
        return tuple(dict.fromkeys(self.devices))

    def coords(self, position: int) -> Dict[str, int]:
        """``{axis name: index}`` of flat position ``position`` (row-major)."""
        out = {}
        for name, n in zip(reversed(self.axis_names), reversed(self.shape)):
            position, out[name] = divmod(position, n)
        return out


SRMesh = Mesh  # the serving mesh's name before the LM meshes were ported


def _indexed(device: torch.device) -> torch.device:
    """A CUDA device with its index (``cuda`` -> the current one), the
    form a tensor's ``.device`` takes, so positions compare with it."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _positions(devices: Sequence[torch.device]) -> Tuple[Optional["torch.cuda.Stream"], ...]:
    return tuple(torch.cuda.Stream(device=d) if d.type == "cuda" else None
                 for d in devices)


def _cuda_devices(shape: Tuple[int, ...]) -> Tuple[torch.device, ...]:
    needed = math.prod(shape)
    avail = torch.cuda.device_count()
    if needed > avail:
        raise ValueError(
            f"mesh ({'x'.join(map(str, shape))}) needs {needed} devices but "
            f"only {avail} CUDA devices are visible; to place several mesh "
            "positions on one card pass devices=[torch.device('cuda:0')] * "
            f"{needed}"
        )
    return tuple(torch.device("cuda", i) for i in range(needed))


def _devices_for(shape: Tuple[int, ...], devices: Sequence) -> Tuple[torch.device, ...]:
    """``devices`` as the mesh's positions: one device repeated at every
    position, or one device per position (row-major), all cpu or all
    cuda."""
    needed = math.prod(shape)
    devs = tuple(_indexed(torch.device(d)) for d in devices)
    if len(devs) == 1:
        devs = devs * needed
    if len(devs) != needed:
        raise ValueError(
            f"mesh ({'x'.join(map(str, shape))}) needs {needed} devices (or one "
            f"for every position), got {len(devs)}"
        )
    kinds = {d.type for d in devs}
    if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
        raise ValueError(f"a mesh runs on cuda or on cpu devices, got {sorted(kinds)}")
    return devs


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``shape`` with axis names ``axes``.

    ``devices`` lists the positions row-major and may repeat a device; a
    list of one device puts it at every position (``["cpu"]`` builds any
    mesh on a host).  Without it the mesh takes the first ``prod(shape)``
    visible GPUs and raises ``ValueError`` when there are too few.  Each
    CUDA position gets a stream of its own, made here.
    """
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if any(n <= 0 for n in shape):
        raise ValueError(f"mesh axes must be positive, got {shape}")
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} needs as many distinct axis names, got {axes}")
    devs = _cuda_devices(shape) if devices is None else _devices_for(shape, devices)
    return Mesh(devices=devs, shape=shape, axis_names=axes, streams=_positions(devs))


def make_production_mesh(*, multi_pod: bool = False, devices: Optional[Sequence] = None) -> Mesh:
    """The LM mesh: ``SINGLE_POD`` (data=16, model=16), or ``MULTI_POD``
    (pod=2, data=16, model=16); ``devices`` as :func:`make_mesh` takes it
    (``["cpu"]`` resolves the rules on a host)."""
    shape, axes = MULTI_POD if multi_pod else SINGLE_POD
    return make_mesh(shape, axes, devices)


def make_sr_mesh(
    replicas: int,
    band_shards: int,
    *,
    device=None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """The serving mesh: ``(replica=R, bands=S)`` over ``R*S`` positions.

    ``devices`` lists the ``R*S`` positions row-major (replica-major) and
    may repeat a device — the port's counterpart of forcing host devices
    with ``XLA_FLAGS``: ``["cpu"] * 4`` for a ``(2, 2)`` mesh on a host,
    ``[torch.device("cuda:0")] * 4`` for one on a single card.  Without it,
    ``device`` names the device type: every position of a ``cpu`` mesh is
    the CPU, and a ``cuda`` mesh (the default) takes the first ``R*S``
    visible GPUs, raising ``ValueError`` when there are too few.  Each CUDA
    position gets a stream of its own, made here.
    """
    if replicas <= 0 or band_shards <= 0:
        raise ValueError(
            f"mesh axes must be positive, got replicas={replicas} "
            f"band_shards={band_shards}"
        )
    if devices is not None and len(devices) != replicas * band_shards:
        raise ValueError(
            f"mesh ({replicas}x{band_shards}) needs {replicas * band_shards} "
            f"devices, got {len(devices)}"
        )
    if devices is None:
        kind = torch.device(device if device is not None else "cuda").type
        if kind not in ("cpu", "cuda"):
            raise ValueError(f"a serving mesh runs on cuda or cpu, not {kind!r}")
        devices = ["cpu"] if kind == "cpu" else None
    return make_mesh((replicas, band_shards), (SR_REPLICA_AXIS, SR_BAND_AXIS), devices)


def band_submesh(mesh: Mesh, replica: int) -> Mesh:
    """One replica's 1-D ``bands`` row of an SR mesh, streams included.

    Each replica runs its own band-sharded executor over this submesh —
    the ``replica`` axis never appears inside an executor (replication is
    pure request routing, handled by ``ReplicaRouter``).
    """
    names = mesh.axis_names
    if names != (SR_REPLICA_AXIS, SR_BAND_AXIS):
        raise ValueError(f"not an SR mesh (axes {names})")
    replicas, shards = mesh.shape
    if not 0 <= replica < replicas:
        raise ValueError(f"replica {replica} not in a mesh of {replicas} replicas")
    row = slice(replica * shards, (replica + 1) * shards)
    return Mesh(
        devices=mesh.devices[row],
        shape=(shards,),
        axis_names=(SR_BAND_AXIS,),
        streams=mesh.streams[row],
    )
