"""Device-mesh construction and sharding policy for the grid hierarchy.

The reference is single-device (one GPU, ``cudaSetDevice(0)`` at
MG_solver_GPU.cu:58; OpenMP threads on the host) — it has no distributed
layer at all. This module is the communication layer this framework adds
(SURVEY.md §2 "Parallelism strategies"): a device mesh shaped by the
algorithm — rows (2-D), row×column blocks (2-D), or z-planes (3-D) — with
levels sharded while they are large enough to be worth it and replicated
below a threshold (the standard geometric-multigrid coarse-level
agglomeration strategy).

Collectives used downstream:
  * ``lax.ppermute``  — one-row halo exchange between row-neighbor devices
    (parallel.halo);
  * ``psum``          — convergence/error reductions (replacing the
    reference's per-block partial sums + host reduction, MG_solver_GPU.cu:1266-1272);
  * implicit GSPMD collectives — resharding at restriction/prolongation
    boundaries in the compiled-program path (compiled.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ROW_AXIS = "rows"

# A level is row-sharded only while every device owns at least this many rows;
# below that the halo:compute ratio makes sharding a loss and the level is
# replicated (coarse-level agglomeration).
DEFAULT_SHARD_THRESHOLD_ROWS = 32


def make_mesh(devices: Optional[Sequence[jax.Device]] = None,
              axis_name: str = ROW_AXIS) -> Mesh:
    """A 1-D mesh over all (or the given) devices, named for the row axis."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def row_sharding(mesh: Mesh, axis_name: str = ROW_AXIS) -> NamedSharding:
    """(n, n) arrays partitioned by contiguous row blocks; columns intact."""
    return NamedSharding(mesh, P(axis_name, None))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """Decides per level whether it is row-sharded or replicated."""

    mesh: Mesh
    axis_name: str = ROW_AXIS
    threshold_rows: int = DEFAULT_SHARD_THRESHOLD_ROWS

    @property
    def n_devices(self) -> int:
        return int(np.prod(list(self.mesh.shape.values())))

    def is_sharded(self, n: int) -> bool:
        return n // self.n_devices >= self.threshold_rows and self.n_devices > 1

    def spec(self, n: int) -> P:
        return P(self.axis_name, None) if self.is_sharded(n) else P()

    def sharding(self, n: int) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec(n))

    def padded_shape(self, n: int) -> tuple[int, int]:
        """Padded layout for level-n arrays under this policy: sharded
        levels pad rows so every device holds an equal block."""
        return _policy_padded_shape(n, self.spec(n), self.mesh)


COL_AXIS = "cols"


def make_mesh_2d(shape: tuple[int, int],
                 devices: Optional[Sequence[jax.Device]] = None,
                 axis_names: tuple[str, str] = (ROW_AXIS, COL_AXIS)) -> Mesh:
    """A 2-D mesh for block partitioning (rows × cols of the grid).

    For multi-host meshes, put the inter-host dimension on the row axis —
    row-block halos are the low-frequency traffic; build ``devices`` with
    ``jax.experimental.mesh_utils.create_hybrid_device_mesh`` in that case.
    """
    if devices is None:
        devices = jax.devices()
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, axis_names)


@dataclasses.dataclass(frozen=True)
class BlockShardingPolicy:
    """2-D block partition: P(rows, cols) while the level is large, falling
    back to rows-only, then replicated (coarse agglomeration) — the
    multi-host layout of SURVEY.md §2 ("block-partitioned FMG")."""

    mesh: Mesh
    row_axis: str = ROW_AXIS
    col_axis: str = COL_AXIS
    threshold_rows: int = DEFAULT_SHARD_THRESHOLD_ROWS

    def _dims(self) -> tuple[int, int]:
        return self.mesh.shape[self.row_axis], self.mesh.shape[self.col_axis]

    def spec(self, n: int) -> P:
        rows_dev, cols_dev = self._dims()
        if n // rows_dev >= self.threshold_rows:
            if cols_dev > 1 and n // cols_dev >= self.threshold_rows:
                return P(self.row_axis, self.col_axis)
            if rows_dev > 1:
                return P(self.row_axis, None)
        return P()

    def is_sharded(self, n: int) -> bool:
        return self.spec(n) != P()

    def sharding(self, n: int) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec(n))

    def padded_shape(self, n: int) -> tuple[int, int]:
        """Padded layout for level-n arrays: rows ×(16·row_devices), columns
        ×(128·col_devices) when the respective axis is sharded."""
        return _policy_padded_shape(n, self.spec(n), self.mesh)


def _policy_padded_shape(n: int, spec: P, mesh: Mesh) -> tuple[int, int]:
    """Padded shape for a level sharded as ``spec`` over ``mesh``: the
    single-device layout (ops.layout) rounded up so each sharded axis
    splits into equal per-device blocks of that layout's granule."""
    from ..ops.layout import COL_PAD, ROW_PAD, padded_shape

    rp, cp = padded_shape(n)
    if len(spec) >= 1 and spec[0] is not None:
        q = ROW_PAD * mesh.shape[spec[0]]
        rp = -(-rp // q) * q
    if len(spec) >= 2 and spec[1] is not None:
        q = COL_PAD * mesh.shape[spec[1]]
        cp = -(-cp // q) * q
    return rp, cp


def padded_rows(n: int, n_devices: int) -> int:
    """Rows after padding to a device-divisible count (shard_map needs equal
    blocks; the GSPMD path does not and never pads)."""
    return -(-n // n_devices) * n_devices


def pad_rows(a: jax.Array, n_devices: int) -> jax.Array:
    """Zero-pad trailing rows so axis 0 divides the device count."""
    import jax.numpy as jnp
    n = a.shape[0]
    np_ = padded_rows(n, n_devices)
    if np_ == n:
        return a
    return jnp.concatenate([a, jnp.zeros((np_ - n,) + a.shape[1:], a.dtype)], axis=0)


def unpad_rows(a: jax.Array, n: int) -> jax.Array:
    return a[:n] if a.shape[0] != n else a


Z_AXIS = "z"


def make_mesh_z(devices: Optional[Sequence[jax.Device]] = None,
                axis_name: str = Z_AXIS) -> Mesh:
    """A 1-D mesh over the z (plane) axis of a cubic grid."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def z_sharding(mesh: Mesh, axis_name: str = Z_AXIS) -> NamedSharding:
    """(n, n, n) volumes partitioned into contiguous z-plane blocks."""
    return NamedSharding(mesh, P(axis_name, None, None))


@dataclasses.dataclass(frozen=True)
class ZShardingPolicy3:
    """Per-level z-plane sharding decisions for the 3-D compiled engine —
    the cubic-hierarchy analog of ``ShardingPolicy``.

    Levels with at least ``threshold_planes`` planes per device are
    partitioned into contiguous z-plane blocks; coarser levels are
    replicated (coarse-level agglomeration). GSPMD handles depths that do
    not divide the device count, so levels keep their (n, n, n) shape."""

    mesh: Mesh
    axis_name: str = Z_AXIS
    threshold_planes: int = 8

    @property
    def n_devices(self) -> int:
        return int(np.prod(list(self.mesh.shape.values())))

    def is_sharded(self, n: int) -> bool:
        return (self.n_devices > 1
                and n // self.n_devices >= self.threshold_planes)

    def spec(self, n: int) -> P:
        return (P(self.axis_name, None, None) if self.is_sharded(n)
                else P())

    def sharding(self, n: int) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec(n))
