"""Device mesh construction.

Replacement for the reference's MPI_COMM_WORLD setup (reference
mpi.cpp:39-47, fft/fft_mpi.cpp:318-323): a 1D `jax.sharding.Mesh` over
the 'rows' axis. Row-block distribution with SPMD closure constants
replaces MPI_Bcast of dims (fft_mpi.cpp:334-337); NamedSharding
placement replaces Scatterv/Gatherv (fft_mpi.cpp:372-378,436-438).

Meshes are built from the default platform's devices only: on a GPU
host the mesh is its cards (NVLink all to all); in tests it is 8 virtual
CPU devices (xla_force_host_platform_device_count), mirroring how the
reference validates MPI modes with oversubscribed local ranks
(README.md:55). Too few devices is an error, never a silent switch to
another platform.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax
from jax.sharding import Mesh

ROWS_AXIS = "rows"
BATCH_AXIS = "batch"


def _devices(n: Optional[int]) -> list:
    devices = jax.devices()
    if n is None:
        return devices
    if len(devices) < n:
        raise ValueError(
            f"need {n} devices, the default platform "
            f"{jax.default_backend()!r} has {len(devices)}"
        )
    return devices[:n]


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1D mesh over the first n devices of the default platform (all by
    default)."""
    return Mesh(_devices(n_devices), (ROWS_AXIS,))


def make_mesh2d(n_batch: int, n_rows: int) -> Mesh:
    """2D (batch, rows) mesh: images data-parallel over 'batch', each
    image's rows sharded over 'rows'.

    The FFT collectives (all_to_all transposes, pmin/pmax normalize) run
    only over the 'rows' axis; 'batch' needs no communication at all —
    the counterpart of running several independent mpirun groups
    (fft_mpi.cpp:89-100 distributes rows within ONE communicator; the
    reference has no batch axis). Every card of a host reaches every
    other at the same NVLink rate, so the mesh follows the algorithm.
    """
    grid = np.asarray(_devices(n_batch * n_rows)).reshape(n_batch, n_rows)
    return Mesh(grid, (BATCH_AXIS, ROWS_AXIS))
