"""The serving mesh: a grid of torch devices, one stream per position.

The SR half of the JAX package's ``launch/mesh.py``.  One Python process
drives every position of the mesh, as the JAX package's single-controller
``shard_map`` does: a :class:`SRMesh` is a ``(replica, bands)`` grid of
``torch.device``\\ s, and on CUDA each position carries its own
``torch.cuda.Stream``, made once here, when the mesh is built — never
inside a launch.

A mesh's positions may repeat a device.  torch has no counterpart of
``--xla_force_host_platform_device_count``, so ``devices=`` is how a mesh
larger than the machine's device count is built: ``["cpu"] * 4`` on a
host, ``[torch.device("cuda:0")] * 4`` on one card, where the positions
are four streams of the same GPU.

``make_production_mesh`` and ``make_mesh`` of the JAX module build the LM
meshes and are not ported (LM scaffolding).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

__all__ = [
    "SRMesh",
    "make_sr_mesh",
    "band_submesh",
    "SR_REPLICA_AXIS",
    "SR_BAND_AXIS",
]

# SR serving mesh axes: ``replica`` is pure data parallelism (whole frames,
# no communication), ``bands`` splits each frame's row bands spatially
# (L-row halo exchange at shard edges).
SR_REPLICA_AXIS = "replica"
SR_BAND_AXIS = "bands"


@dataclasses.dataclass(frozen=True, eq=False)
class SRMesh:
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


def _indexed(device: torch.device) -> torch.device:
    """A CUDA device with its index (``cuda`` -> the current one), the
    form a tensor's ``.device`` takes, so positions compare with it."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _positions(devices: Sequence[torch.device]) -> Tuple[Optional["torch.cuda.Stream"], ...]:
    return tuple(torch.cuda.Stream(device=d) if d.type == "cuda" else None
                 for d in devices)


def _cuda_devices(needed: int, replicas: int, band_shards: int) -> Tuple[torch.device, ...]:
    avail = torch.cuda.device_count()
    if needed > avail:
        raise ValueError(
            f"mesh ({replicas}x{band_shards}) needs {needed} devices but "
            f"only {avail} CUDA devices are visible; to place several mesh "
            "positions on one card pass devices=[torch.device('cuda:0')] * "
            f"{needed}"
        )
    return tuple(torch.device("cuda", i) for i in range(needed))


def make_sr_mesh(
    replicas: int,
    band_shards: int,
    *,
    device=None,
    devices: Optional[Sequence] = None,
) -> SRMesh:
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
    needed = replicas * band_shards
    if devices is not None:
        devs = tuple(_indexed(torch.device(d)) for d in devices)
        if len(devs) != needed:
            raise ValueError(
                f"mesh ({replicas}x{band_shards}) needs {needed} devices, "
                f"got {len(devs)}"
            )
        kinds = {d.type for d in devs}
        if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
            raise ValueError(
                f"a serving mesh runs on cuda or on cpu devices, got {sorted(kinds)}"
            )
    else:
        kind = torch.device(device if device is not None else "cuda").type
        if kind == "cpu":
            devs = (torch.device("cpu"),) * needed
        elif kind == "cuda":
            devs = _cuda_devices(needed, replicas, band_shards)
        else:
            raise ValueError(f"a serving mesh runs on cuda or cpu, not {kind!r}")
    return SRMesh(
        devices=devs,
        shape=(replicas, band_shards),
        axis_names=(SR_REPLICA_AXIS, SR_BAND_AXIS),
        streams=_positions(devs),
    )


def band_submesh(mesh: SRMesh, replica: int) -> SRMesh:
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
    return SRMesh(
        devices=mesh.devices[row],
        shape=(shards,),
        axis_names=(SR_BAND_AXIS,),
        streams=mesh.streams[row],
    )
