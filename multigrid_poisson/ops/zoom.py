"""The unified bilinear "zoom" primitive: general N→M grid resampling.

The key structural insight carried over from the reference's GPU design:
restriction and prolongation are the *same* resampling op with swapped
arguments (ker_Zoom_GPU, MG_solver_GPU.cu:913-958, called with opposite
argument orders at .cu:1345 and .cu:1406). Both grids are vertex-centered
with aligned corners, so a target point ``i`` maps to source coordinate
``s = i · (n_src − 1) / (n_dst − 1)`` and is bilinearly interpolated from the
4 surrounding source points — exactly the fractional-weight scheme of the CPU
doRestriction (MG_solver_CPU.cpp:640-680) and doProlongation
(MG_solver_CPU.cpp:682-724).

The op is separable, so it is implemented as two 1-D interpolations expressed
as small dense matmuls. For an (n_src × n_src) → (n_dst × n_dst) zoom this is
two (n_dst × n_src) · matrix products instead of the reference's per-point
texture fetches.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np


@lru_cache(maxsize=None)
def _zoom_matrix_np(n_src: int, n_dst: int, dtype_name: str) -> np.ndarray:
    """Dense 1-D align-corners linear-interpolation matrix W: (n_dst, n_src).

    out[i] = Σ_j W[i, j] · src[j], with W rows having ≤ 2 nonzeros
    (1−w at floor(s), w at floor(s)+1). Built in float64 then cast.
    """
    s = np.arange(n_dst, dtype=np.float64) * ((n_src - 1) / (n_dst - 1))
    i0 = np.clip(np.floor(s).astype(np.int64), 0, n_src - 2)
    w = s - i0
    mat = np.zeros((n_dst, n_src), dtype=np.float64)
    rows = np.arange(n_dst)
    mat[rows, i0] = 1.0 - w
    mat[rows, i0 + 1] = w
    return mat.astype(dtype_name)


def zoom_matrix(n_src: int, n_dst: int, dtype=jnp.float32) -> jnp.ndarray:
    return jnp.asarray(_zoom_matrix_np(n_src, n_dst, jnp.dtype(dtype).name))


@partial(jax.jit, static_argnames=("n_dst", "zero_boundary"))
def zoom(src: jnp.ndarray, n_dst: int, zero_boundary: bool = False) -> jnp.ndarray:
    """Bilinearly resample an (n, n) grid to (n_dst, n_dst), corners aligned.

    zero_boundary=True forces the output border to 0 — restriction semantics
    (the restricted residual lives in a zero-Dirichlet correction space,
    MG_solver_CPU.cpp:651-652 "Initialize Coarse Grid, set 0 to all" +
    interior-only loop).
    """
    n_src = src.shape[0]
    if n_dst == n_src:
        out = src
    else:
        wy = zoom_matrix(n_src, n_dst, src.dtype)      # (n_dst, n_src)
        # rows:  tmp = W · src   (n_dst, n_src) ; cols: out = tmp · Wᵀ
        # precision=HIGHEST: a float32 matmul may otherwise run at reduced
        # input precision (TF32), degrading the transfer operators.
        tmp = jnp.dot(wy, src, preferred_element_type=src.dtype,
                      precision=jax.lax.Precision.HIGHEST)
        out = jnp.dot(tmp, wy.T, preferred_element_type=src.dtype,
                      precision=jax.lax.Precision.HIGHEST)
    if zero_boundary:
        out = out.at[0, :].set(0).at[-1, :].set(0).at[:, 0].set(0).at[:, -1].set(0)
    return out


@partial(jax.jit, static_argnames=("n_dst", "zero_boundary"))
def zoom3(src: jnp.ndarray, n_dst: int, zero_boundary: bool = False) -> jnp.ndarray:
    """Trilinearly resample an (n, n, n) volume to (n_dst,)³, corners aligned.

    The 3-D member of the unified zoom family (same 1-D interpolation matrix
    as ``zoom``, applied separably along all three axes), used by the 3-D
    schedule engine (solver3) for general N→M restriction/prolongation —
    the reference's doRestriction/doProlongation generalized one dimension up.
    """
    n_src = src.shape[0]
    if n_dst == n_src:
        out = src
    else:
        w = zoom_matrix(n_src, n_dst, src.dtype)       # (n_dst, n_src)
        hi = jax.lax.Precision.HIGHEST
        # contract each axis in turn: result axes cycle to keep the matmul on
        # the leading axis; three passes restore the original axis order.
        out = src
        for _ in range(3):
            out = jnp.tensordot(w, out, axes=((1,), (0,)),
                                precision=hi).transpose(1, 2, 0)
        out = out.astype(src.dtype)
    if zero_boundary:
        mask = jnp.zeros((n_dst,) * 3, bool).at[1:-1, 1:-1, 1:-1].set(True)
        out = jnp.where(mask, out, jnp.zeros_like(out))
    return out


def restrict_residual(d: jnp.ndarray, n_coarse: int) -> jnp.ndarray:
    """Coarse-level RHS = zoom of the *negated* fine residual, zero boundary.

    The scheduler's down-leg: F_coarse = restrict(−D_fine)
    (MG_solver_CPU.cpp:274-287).
    """
    return zoom(-d, n_coarse, zero_boundary=True)


def prolongate(u_coarse: jnp.ndarray, n_fine: int) -> jnp.ndarray:
    """Fine-level correction = zoom of the coarse solution (MG_solver_CPU.cpp:682-724)."""
    return zoom(u_coarse, n_fine, zero_boundary=False)
