"""Multi-host initialization and hosts × devices mesh construction.

The reference is strictly single-process/single-device (SURVEY.md §2:
``cudaSetDevice(0)``, no MPI/NCCL anywhere). This module is the multi-host
entry this framework adds. It cannot be exercised in a
single-host environment, but the API is the standard JAX recipe and the mesh
logic is unit-testable single-host:

    from multigrid_poisson.parallel import multihost
    multihost.initialize()                       # jax.distributed, all hosts
    mesh = multihost.hybrid_block_mesh()          # hosts × devices → 2-D grid mesh
    policy = multihost.block_policy(mesh)
    cc = mg.compile_program(program, problem, policy=policy)

Layout rationale: the grid's row axis maps to the inter-host dimension —
row-block boundaries exchange one halo row per sweep, the lowest-frequency
traffic — while the column axis stays inside a host.
Coarse levels drop to rows-only and then replicated partitioning
(BlockShardingPolicy), the standard multigrid agglomeration schedule.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np

from .mesh import COL_AXIS, ROW_AXIS, BlockShardingPolicy, Mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """``jax.distributed.initialize``; with no arguments JAX's cluster
    auto-detection supplies them."""
    # the idempotence guard must NOT query jax.process_count(): that
    # initializes the XLA backend, after which distributed.initialize
    # refuses to run at all (caught by the real multi-process harness,
    # examples/exp_multihost_cpu.py) — ask the distributed runtime itself
    from jax._src import distributed as _dist

    if getattr(_dist.global_state, "client", None) is not None:
        return  # already initialized
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def hybrid_block_mesh(rows_parallelism: Optional[int] = None) -> Mesh:
    """A 2-D (rows × cols) device mesh with hosts on the row axis.

    Single-host: factors the local devices into a near-square 2-D mesh.
    Multi-host: rows = hosts, cols = devices per host, via
    ``mesh_utils.create_hybrid_device_mesh``.
    """
    n_hosts = jax.process_count()
    n_local = jax.local_device_count()
    if n_hosts > 1:
        from jax.experimental import mesh_utils

        # devices may expose a slice_index per inter-host granule; under
        # the multi-process CPU/GPU runtime every device reports slice 0 —
        # fall back to process-as-granule whenever the slice structure does
        # not distinguish the hosts (exp_multihost_cpu.py exercises this
        # for real: 2 local processes, gloo-coordinated)
        slice_ids = {getattr(d, "slice_index", None) for d in jax.devices()}
        granule_is_process = len(slice_ids) != n_hosts or None in slice_ids
        devices = mesh_utils.create_hybrid_device_mesh(
            mesh_shape=(1, n_local), dcn_mesh_shape=(n_hosts, 1),
            process_is_granule=granule_is_process)
        return Mesh(devices, (ROW_AXIS, COL_AXIS))
    total = len(jax.devices())
    rows = rows_parallelism or _near_square_factor(total)
    arr = np.asarray(jax.devices()).reshape(rows, total // rows)
    return Mesh(arr, (ROW_AXIS, COL_AXIS))


def block_policy(mesh: Mesh, threshold_rows: int = 32) -> BlockShardingPolicy:
    return BlockShardingPolicy(mesh, threshold_rows=threshold_rows)


def _near_square_factor(n: int) -> int:
    """Largest factor of n that is ≤ √n (8 → 2×4, 16 → 4×4, 6 → 2×3)."""
    best = 1
    f = 1
    while f * f <= n:
        if n % f == 0:
            best = f
        f += 1
    return best
