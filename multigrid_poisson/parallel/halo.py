"""Halo-exchange stencil ops under ``shard_map``: the explicit SPMD hot path.

The reference has no domain decomposition (single device, SURVEY.md §2).
This module adds it: each device owns a contiguous block of grid rows,
one-row halos move between ring neighbors with ``lax.ppermute`` (a
collective-permute, NCCL on GPUs), and error reductions are ``lax.psum`` — the
distributed replacement for the reference's shared-memory block reductions +
host-side final sum (MG_solver_GPU.cu:640-661, 1266-1272).

Design notes
  * Row blocks must be equal-sized under shard_map, so callers pad axis 0 to a
    device-divisible row count (mesh.pad_rows); a global-row-index mask keeps
    the Dirichlet boundary rows and dead padding rows frozen, which also makes
    the wrap-around values of the ring ppermute harmless (they only reach
    masked rows).
  * Each sweep is split into interior rows (no halo needed) and the two edge
    rows (halo needed). The interior update carries no data dependency on the
    ppermute results, so XLA is free to overlap the collective with the bulk
    of the compute — the halo-latency-hiding structure SURVEY.md §7 calls for.
  * The local per-block update is a plain jnp stencil, which XLA fuses.

All functions in this module are written *per-shard* (inside shard_map): they
take the local (rows_local, n) block and the mesh axis name.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from .mesh import ROW_AXIS, pad_rows, unpad_rows


# --- per-shard building blocks ------------------------------------------------

def _ring_perms(ndev: int):
    fwd = [(i, (i + 1) % ndev) for i in range(ndev)]   # send to next (row-below owner)
    bwd = [(i, (i - 1) % ndev) for i in range(ndev)]   # send to previous
    return fwd, bwd


def exchange_halo(u_loc: jnp.ndarray, axis: str) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Return (row_above, row_below) for this block, each shape (1, n).

    row_above is the last row of the previous device's block; row_below is the
    first row of the next device's block. Ring wrap-around values land only on
    globally-masked rows and are never used.
    """
    ndev = lax.axis_size(axis)
    fwd, bwd = _ring_perms(ndev)
    row_above = lax.ppermute(u_loc[-1:], axis, fwd)
    row_below = lax.ppermute(u_loc[:1], axis, bwd)
    return row_above, row_below


def _global_row_index(rows_local: int, axis: str) -> jnp.ndarray:
    """Global row index of each local row, shape (rows_local, 1)."""
    idx = lax.axis_index(axis)
    local = lax.broadcasted_iota(jnp.int32, (rows_local, 1), 0)
    return idx * rows_local + local


def _interior_row_mask(rows_local: int, n: int, axis: str) -> jnp.ndarray:
    """True for rows whose *global* index is a PDE interior row (1..n-2)."""
    g = _global_row_index(rows_local, axis)
    return jnp.logical_and(g >= 1, g <= n - 2)


def jacobi_sweep_shard(u_loc: jnp.ndarray, f_loc: jnp.ndarray, h: float, n: int,
                       axis: str = ROW_AXIS, omega: float = 1.0) -> jnp.ndarray:
    """One damped-Jacobi sweep on a row block, halo-aware and boundary-masked.

    Matches ops.stencils.jacobi_sweep (itself doSmoothing,
    MG_solver_CPU.cpp:573-604) on the global array.
    """
    rows = u_loc.shape[0]
    h2 = jnp.asarray(h * h, u_loc.dtype)
    om = jnp.asarray(omega, u_loc.dtype)

    row_above, row_below = exchange_halo(u_loc, axis)

    # Interior rows of the block (local 1..rows-2): pure local stencil — no
    # dependency on the ppermute above, so the collective overlaps this.
    nb_int = (u_loc[:-2, 1:-1] + u_loc[2:, 1:-1]
              + u_loc[1:-1, :-2] + u_loc[1:-1, 2:])
    incr_int = 0.25 * (nb_int - 4.0 * u_loc[1:-1, 1:-1] - h2 * f_loc[1:-1, 1:-1])

    # Edge rows (local 0 and rows-1): need the halo rows.
    def edge_incr(u_row, f_row, nbr_vert_a, nbr_vert_b):
        nb = (nbr_vert_a[0, 1:-1] + nbr_vert_b[0, 1:-1]
              + u_row[:-2] + u_row[2:])
        return 0.25 * (nb - 4.0 * u_row[1:-1] - h2 * f_row[1:-1])

    incr_top = edge_incr(u_loc[0], f_loc[0], row_above, u_loc[1:2])
    incr_bot = edge_incr(u_loc[-1], f_loc[-1], u_loc[-2:-1], row_below)

    incr = jnp.concatenate(
        [incr_top[None, :], incr_int, incr_bot[None, :]], axis=0)

    new = u_loc.at[:, 1:-1].add(om * incr)
    mask = _interior_row_mask(rows, n, axis)
    return jnp.where(mask, new, u_loc)


def redblack_gs_sweep_shard(u_loc: jnp.ndarray, f_loc: jnp.ndarray, h: float, n: int,
                            axis: str = ROW_AXIS) -> jnp.ndarray:
    """One red-black Gauss-Seidel sweep (even half then odd half) on a row block.

    Global-parity masks make the result identical to ops.stencils.redblack_gs_sweep
    regardless of the row partition (parity is computed from global indices).
    """
    rows = u_loc.shape[0]
    h2 = jnp.asarray(h * h, u_loc.dtype)
    g = _global_row_index(rows, axis)                            # (rows, 1)
    col = lax.broadcasted_iota(jnp.int32, (rows, u_loc.shape[1]), 1)
    parity = (g + col) % 2                                       # (rows, n)
    row_ok = _interior_row_mask(rows, n, axis)
    col_ok = jnp.zeros(u_loc.shape[1], jnp.bool_).at[1:-1].set(True)
    interior = jnp.logical_and(row_ok, col_ok[None, :])

    def half(u, color):
        row_above, row_below = exchange_halo(u, axis)
        up = jnp.concatenate([row_above, u, row_below], axis=0)  # (rows+2, ncols)
        nb = up[:-2, 1:-1] + up[2:, 1:-1] + up[1:-1, :-2] + up[1:-1, 2:]
        val = 0.25 * (nb - h2 * f_loc[:, 1:-1])
        take = jnp.logical_and(parity[:, 1:-1] == color, interior[:, 1:-1])
        return u.at[:, 1:-1].set(jnp.where(take, val, u[:, 1:-1]))

    return half(half(u_loc, 0), 1)


def residual_shard(u_loc: jnp.ndarray, f_loc: jnp.ndarray, h: float, n: int,
                   axis: str = ROW_AXIS) -> jnp.ndarray:
    """Per-block 5-point residual, 0 on global boundary and padding rows."""
    rows = u_loc.shape[0]
    inv_h2 = jnp.asarray(1.0 / (h * h), u_loc.dtype)
    row_above, row_below = exchange_halo(u_loc, axis)
    up = jnp.concatenate([row_above, u_loc, row_below], axis=0)
    nb = up[:-2, 1:-1] + up[2:, 1:-1] + up[1:-1, :-2] + up[1:-1, 2:]
    r_int = inv_h2 * (nb - 4.0 * u_loc[:, 1:-1]) - f_loc[:, 1:-1]
    r = jnp.zeros_like(u_loc).at[:, 1:-1].set(r_int)
    mask = _interior_row_mask(rows, n, axis)
    return jnp.where(mask, r, jnp.zeros_like(r))


def smoothing_error_shard(u_loc, f_loc, h: float, n: int, axis: str = ROW_AXIS,
                          compat: bool = True) -> jnp.ndarray:
    """Distributed smoothing-error metric: local masked partial sum + psum.

    compat=True reproduces the reference's color-bugged metric (even-color
    residuals counted twice, /N² — MG_solver_CPU.cpp:606-622) so trigger
    schedules sweep identically whether sharded or not.
    """
    r = residual_shard(u_loc, f_loc, h, n, axis)
    if compat:
        rows = u_loc.shape[0]
        g = _global_row_index(rows, axis)
        col = lax.broadcasted_iota(jnp.int32, u_loc.shape, 1)
        even = ((g + col) % 2 == 0).astype(u_loc.dtype)
        local = 2.0 * jnp.sum(jnp.abs(r) * even)
    else:
        local = jnp.sum(jnp.abs(r))
    return lax.psum(local, axis) / (n * n)


# --- whole-array wrappers (shard_map entry points) ---------------------------

def _wrap(fn: Callable, mesh: Mesh, axis: str, n_outs: int = 1):
    spec = P(axis, None)
    out_specs = spec if n_outs == 1 else tuple([spec] * n_outs)
    return shard_map(fn, mesh=mesh, in_specs=(spec, spec),
                     out_specs=out_specs, check_vma=False)


@partial(jax.jit, static_argnames=("h", "steps", "mesh", "axis", "omega", "smoother"))
def sharded_smooth(u: jnp.ndarray, f: jnp.ndarray, h: float, steps: int,
                   mesh: Mesh, axis: str = ROW_AXIS, omega: float = 1.0,
                   smoother: str = "jacobi") -> jnp.ndarray:
    """``steps`` smoothing sweeps on a row-sharded (padded) global array.

    Inputs must be padded to a device-divisible row count (mesh.pad_rows) and
    placed with row sharding; ``n`` (the true grid size) is inferred from the
    column count, which is never padded.
    """
    n = u.shape[1]
    sweeps = {"jacobi": partial(jacobi_sweep_shard, omega=omega),
              "rbgs": redblack_gs_sweep_shard}[smoother]

    def body(u_loc, f_loc):
        def one(_, v):
            return sweeps(v, f_loc, h, n, axis)
        return lax.fori_loop(0, steps, one, u_loc)

    return _wrap(body, mesh, axis)(u, f)


@partial(jax.jit, static_argnames=("h", "mesh", "axis"))
def sharded_residual(u: jnp.ndarray, f: jnp.ndarray, h: float, mesh: Mesh,
                     axis: str = ROW_AXIS) -> jnp.ndarray:
    n = u.shape[1]
    return _wrap(partial(residual_shard, h=h, n=n, axis=axis), mesh, axis)(u, f)


@partial(jax.jit, static_argnames=("h", "mesh", "axis", "compat"))
def sharded_smoothing_error(u, f, h: float, mesh: Mesh, axis: str = ROW_AXIS,
                            compat: bool = True) -> jnp.ndarray:
    n = u.shape[1]
    fn = partial(smoothing_error_shard, h=h, n=n, axis=axis, compat=compat)
    spec = P(axis, None)
    return shard_map(fn, mesh=mesh, in_specs=(spec, spec), out_specs=P(),
                     check_vma=False)(u, f)


__all__ = [
    "exchange_halo", "jacobi_sweep_shard", "redblack_gs_sweep_shard",
    "residual_shard", "smoothing_error_shard",
    "sharded_smooth", "sharded_residual", "sharded_smoothing_error",
    "pad_rows", "unpad_rows",
]
