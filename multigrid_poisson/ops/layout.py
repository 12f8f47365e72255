"""Padded layout for 2-D level arrays.

Grid sizes in this framework are arbitrary (the reference's con_N rules
produce 2^k, 2^k+1, or any decrement sequence). The compiled engine stores
every level as a padded (R16(n), C128(n)) array: true grid in the top-left
(n, n) corner, zeros elsewhere, so rows and columns split evenly across
devices under a sharding policy. Padding is applied ONCE per level per
solve — all ops (padded jnp stencils, zoom) work on the padded layout
directly, so no repacking traffic hits the iteration path. Whether the GPU
path needs any padding at all is an open question (ROADMAP D3).

Invariant maintained by every padded op: cells outside the true (n, n)
corner are zero, and the true boundary ring (row/col 0 and n−1) is frozen.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

ROW_PAD = 16
COL_PAD = 128


def pad_rows_to(n: int) -> int:
    return -(-n // ROW_PAD) * ROW_PAD


def pad_cols_to(n: int) -> int:
    return -(-n // COL_PAD) * COL_PAD


def padded_shape(n: int) -> tuple[int, int]:
    return pad_rows_to(n), pad_cols_to(n)


@partial(jax.jit, static_argnames=())
def pad_grid(a: jnp.ndarray) -> jnp.ndarray:
    """(n, n) → (R8(n), C128(n)) with zero fill."""
    n = a.shape[0]
    rp, cp = padded_shape(n)
    if (rp, cp) == a.shape:
        return a
    return jnp.zeros((rp, cp), a.dtype).at[:n, :n].set(a)


def pad_grid_to(a: jnp.ndarray, shape: tuple[int, int]) -> jnp.ndarray:
    """(n, n) → ``shape`` with zero fill (policy-padded layouts: sharded
    levels round rows/lanes up to per-device tile multiples)."""
    if tuple(a.shape) == tuple(shape):
        return a
    return jnp.zeros(shape, a.dtype).at[:a.shape[0], :a.shape[1]].set(a)


def unpad_grid(a: jnp.ndarray, n: int) -> jnp.ndarray:
    return a[:n, :n]


def interior_mask(n: int, shape: tuple[int, int], dtype=jnp.bool_) -> jnp.ndarray:
    """True on PDE-interior cells (1..n−2 both dims) of a padded array."""
    r = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    c = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    m = (r >= 1) & (r <= n - 2) & (c >= 1) & (c <= n - 2)
    return m if dtype == jnp.bool_ else m.astype(dtype)


def valid_mask(n: int, shape: tuple[int, int], dtype=jnp.bool_) -> jnp.ndarray:
    """True on true-grid cells (0..n−1 both dims) of a padded array."""
    r = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    c = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    m = (r <= n - 1) & (c <= n - 1)
    return m if dtype == jnp.bool_ else m.astype(dtype)
