"""Device mesh construction and sharding helpers.

The reference's parallelism axes (SURVEY §2.7) map onto a JAX device mesh:

  SIMT lanes            -> GPU lanes / vector lanes (implicit)
  warps/cores           -> XLA intra-device parallelism (implicit)
  tile striping across raster units (raster_unit.cpp:224-227)
                        -> the 'tiles' mesh axis across devices/hosts
  cluster barriers      -> lax.psum collectives

Multi-host bring-up uses jax.distributed; on one host the same code runs on
the local devices (or on the virtual CPU mesh used by tests).
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

TILE_AXIS = "tiles"


def make_mesh(n_devices: int | None = None, axis: str = TILE_AXIS) -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"need {n_devices} devices, have {len(devices)}"
            )
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def make_mesh_2d(n_hosts: int, n_chips: int,
                 axes: tuple = ("hosts", TILE_AXIS)) -> Mesh:
    """hosts x chips mesh (SURVEY §2.8 multi-host DP): tiles stripe over
    BOTH axes (the sharding layers treat all mesh axes as one tile axis),
    so gradient psums reduce over ICI within a host and DCN across hosts
    in a single collective.  On one host / the CPU test mesh this is the
    same devices reshaped — semantics are identical to the 1D mesh."""
    devices = jax.devices()
    n = n_hosts * n_chips
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    return Mesh(np.array(devices[:n]).reshape(n_hosts, n_chips), axes)


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None):
    """Multi-host bring-up (jax.distributed.initialize wrapper).

    No-op on single-host; reads the standard env configuration when
    arguments are omitted.
    """
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(coordinator, num_processes, process_id)


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0,
                    fill=0) -> np.ndarray:
    n = arr.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return arr
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, target - n)
    return np.pad(arr, pad, constant_values=fill)


def tile_sharding(mesh: Mesh, ndim: int, axis: str = TILE_AXIS):
    """NamedSharding that splits the leading (tile) dimension."""
    spec = P(axis, *([None] * (ndim - 1)))
    return NamedSharding(mesh, spec)
