"""Exact coarse-grid solvers.

Two solver families, mirroring the reference's options (doExactSolver,
MG_solver_CPU.cpp:627-638):

  * option 0 — direct dense solve. The reference hand-rolls an O((N²)³)
    LU decomposition with pivoting (InverseMatrix, MG_solver_CPU.cpp:758-950);
    here the (tiny, coarse-level-only) operator inverse is precomputed once on
    the host in float64 and cached, so every subsequent coarse solve is a
    single device matmul, with no factorization on the critical path.
  * option 1 — red-black Gauss-Seidel iterated until the mean absolute
    interior residual drops below ``target_error``
    (GaussSeidel, MG_solver_CPU.cpp:952-1066). The reference syncs the error
    back to the host every iteration (MG_solver_GPU.cu:1507-1522); here the
    whole loop is a device-side ``lax.while_loop`` with a scalar predicate —
    zero host round-trips.

Both zero-initialize U, like the reference (memset at MG_solver_CPU.cpp:993;
InverseMatrix zeroes X at :788).
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from .stencils import redblack_gs_sweep, residual


@lru_cache(maxsize=None)
def _poisson_matrix_np(n: int, h: float) -> np.ndarray:
    """Dense (n², n²) 5-point Laplacian with identity rows on the boundary.

    Row ordering is the flat [iy, ix] layout. Mirrors the operator assembled
    at MG_solver_CPU.cpp:802-832 (boundary row = identity, interior row =
    (−4/h², 1/h² × 4 neighbors)).
    """
    m = n * n
    a = np.zeros((m, m), dtype=np.float64)
    inv_h2 = 1.0 / (h * h)
    for iy in range(n):
        for ix in range(n):
            row = iy * n + ix
            if ix == 0 or ix == n - 1 or iy == 0 or iy == n - 1:
                a[row, row] = 1.0
            else:
                a[row, row] = -4.0 * inv_h2
                a[row, row - 1] = inv_h2
                a[row, row + 1] = inv_h2
                a[row, row - n] = inv_h2
                a[row, row + n] = inv_h2
    return a


@lru_cache(maxsize=None)
def _poisson_inverse_np(n: int, h: float, dtype_name: str) -> np.ndarray:
    """Host-cached A⁻¹ for the assembled operator, per (n, h, dtype).

    Computed on the host in float64, then cast.
    Cached as a NumPy array — NEVER as a jax value: a jax array created the
    first time inside a jit trace would be a tracer, and caching it leaks it
    into every later trace (UnexpectedTracerError). A is well-conditioned at
    coarse sizes (cond ≈ (2/(πh))²), so the explicit inverse loses no
    meaningful accuracy, and applying it is a single matmul.
    """
    inv = np.linalg.inv(_poisson_matrix_np(n, h))
    return inv.astype(dtype_name)


def dense_solve(f: jnp.ndarray, h: float) -> jnp.ndarray:
    """Direct solve of the boundary-aware dense system A·u = f.

    ``f`` carries the RHS on the interior and the Dirichlet values on the
    border (identity rows), exactly like InverseMatrix's F argument.
    """
    n = f.shape[0]
    a_inv = jnp.asarray(_poisson_inverse_np(n, h, jnp.dtype(f.dtype).name))
    u = jnp.dot(a_inv, f.reshape(-1), preferred_element_type=f.dtype,
                precision=jax.lax.Precision.HIGHEST)
    return u.reshape(n, n)


@partial(jax.jit, static_argnames=("h", "norm", "max_iters"))
def gauss_seidel_solve(
    f: jnp.ndarray,
    h: float,
    target_error: float,
    norm: str = "interior",
    max_iters: int = 100_000,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Red-black GS from U = 0 until mean |interior residual| ≤ target_error.

    Returns (u, final_error, iterations). ``norm`` selects the normalization:
    "interior" divides by (n−2)² (CPU reference, MG_solver_CPU.cpp:1059) and
    "full" by n² (GPU reference, MG_solver_GPU.cu:1521). ``max_iters`` is a
    divergence backstop the reference lacks.

    The convergence metric uses the *compensated* residual (ops.precision):
    the naive fp32 residual has an eps·|u|/h² noise floor that can sit above
    tight targets like 1e-7 — the iteration then spins at max_iters without
    ever "converging" (10⁶ iterations at n=8 with the naive metric).
    """
    from .precision import residual_compensated

    n = f.shape[0]
    denom = {"interior": (n - 2) * (n - 2), "full": n * n}[norm]
    # zero interior start (reference memset, MG_solver_CPU.cpp:993); the border
    # carries the Dirichlet data that ``f``'s identity rows hold (0 in the
    # reference problem), kept fixed by the interior-only sweeps.
    u0 = jnp.zeros_like(f)
    u0 = u0.at[0, :].set(f[0, :]).at[-1, :].set(f[-1, :]) \
        .at[:, 0].set(f[:, 0]).at[:, -1].set(f[:, -1])
    tgt = jnp.asarray(target_error, f.dtype)

    def err_of(u):
        r = residual_compensated(u, f, h)
        return jnp.sum(jnp.abs(r[1:-1, 1:-1])) / denom

    # Stagnation detector: fp32 GS cannot push the true residual below the
    # state-precision floor (~eps·|u|/h²); if the target sits under that
    # floor the reference-style loop would spin at max_iters (observed:
    # 10⁵ iterations, 200 ms, at n=8 for target 1e-7). Stop after 128
    # consecutive sweeps without meaningful improvement on the best error.
    STALL_LIMIT = 128

    def cond(state):
        _, err, it, _, stall = state
        return jnp.logical_and(err > tgt,
                               jnp.logical_and(it < max_iters,
                                               stall < STALL_LIMIT))

    def body(state):
        u, _, it, best, stall = state
        u = redblack_gs_sweep(u, f, h)
        err = err_of(u)
        improved = err < best * (1.0 - 1e-6)
        best = jnp.minimum(best, err)
        stall = jnp.where(improved, 0, stall + 1)
        return u, err, it + 1, best, stall

    init = (u0, tgt + 1.0, jnp.asarray(0, jnp.int32),
            jnp.asarray(jnp.finfo(f.dtype).max, f.dtype),
            jnp.asarray(0, jnp.int32))
    u, err, iters, _, _ = jax.lax.while_loop(cond, body, init)
    return u, err, iters


def exact_solve(f: jnp.ndarray, h: float, target_error: float, option: int) -> jnp.ndarray:
    """Dispatch mirroring doExactSolver (MG_solver_CPU.cpp:627-638).

    option 0: direct dense solve (target_error unused).
    option 1: red-black Gauss-Seidel to target_error (fp64 GPU analog).
    option 2: red-black Gauss-Seidel in float32 (fp32 GPU analog,
              MG_solver_GPU.cu:1296-1299), result cast back to f.dtype.
    """
    if option == 0:
        return dense_solve(f, h)
    if option == 1:
        u, _, _ = gauss_seidel_solve(f, h, target_error)
        return u
    if option == 2:
        u, _, _ = gauss_seidel_solve(f.astype(jnp.float32), h, target_error)
        return u.astype(f.dtype)
    raise ValueError(f"unknown exact-solver option {option}; expected 0, 1, or 2")
