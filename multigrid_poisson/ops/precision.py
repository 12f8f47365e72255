"""Compensated (double-float) arithmetic for residual evaluation.

Why this exists: the 5-point residual r = (u_E + u_W + u_N + u_S − 4u_C)/h² − f
subtracts numbers that agree to ~h² relative — catastrophic cancellation. In
fp32 the noise floor of a naive evaluation is ~eps·|u|/h² per point, which
grows like N²: at N = 4097 it reads O(100) in relative-residual units while
the actual iterate is converged. The reference never hits this because its
hierarchy is fp64 on the host (linkedlist.cpp mallocs doubles). This
framework's inversion of the reference's precision layer (C15,
MG_solver_GPU.cu:1067-1071) is: keep the iterate in fp32, and evaluate the
cancellation-prone sum with error-free transformations (Knuth two-sum /
Dekker two-product), i.e. double-float arithmetic. ~6 extra fp32 flops per
two-sum — no extra bytes moved, accuracy equal to fp64 evaluation of the same
fp32 iterate.

Used for: convergence metrics, coarse-solver stopping tests, and the
restriction source (the residual that becomes the coarse RHS) at large N.
"""

from __future__ import annotations

import jax.numpy as jnp


def two_sum(a, b):
    """Error-free transformation: a + b = s + e exactly (Knuth 2Sum, 6 flops)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def neighbor_sum_df(u: jnp.ndarray):
    """Σ4 neighbors − 4u over the interior as a double-float (hi, lo) pair.

    The exact value of (u_N + u_S + u_W + u_E − 4·u_C) for the *stored* fp32
    values, accurate to fp32 eps of the (tiny, cancelled) result rather than
    of the operands. Shapes (n−2, n−2).
    """
    un = u[:-2, 1:-1]
    us = u[2:, 1:-1]
    uw = u[1:-1, :-2]
    ue = u[1:-1, 2:]
    uc = u[1:-1, 1:-1]

    # Sum the five terms (−4u split as four −u adds keeps every step exact
    # under two-sum; a single −4u term would round before compensation).
    hi, lo = two_sum(un, us)
    hi, lo2 = two_sum(hi, uw)
    lo = lo + lo2
    hi, lo2 = two_sum(hi, ue)
    lo = lo + lo2
    for _ in range(4):
        hi, lo2 = two_sum(hi, -uc)
        lo = lo + lo2
    hi, lo = two_sum(hi, lo)
    return hi, lo


def residual_compensated(u: jnp.ndarray, f: jnp.ndarray, h: float) -> jnp.ndarray:
    """5-point residual with a compensated stencil sum; 0 on the boundary.

    Same contract as ops.stencils.residual (getResidual,
    MG_solver_CPU.cpp:554-564) but immune to the fp32 eps/h² cancellation
    noise: r = (hi + lo)/h² − f evaluated as ((hi/h² − f) + lo/h²) so the
    large-term subtraction happens before the compensation is folded in.
    """
    hi, lo = neighbor_sum_df(u)
    inv_h2 = jnp.asarray(1.0 / (h * h), u.dtype)
    r_int = (hi * inv_h2 - f[1:-1, 1:-1]) + lo * inv_h2
    return jnp.zeros_like(u).at[1:-1, 1:-1].set(r_int)


def mean_abs_interior_residual_compensated(u, f, h: float) -> jnp.ndarray:
    """Compensated version of the CPU exact-solver convergence metric
    (mean |interior residual|, MG_solver_CPU.cpp:1043-1059)."""
    r = residual_compensated(u, f, h)
    n = u.shape[0]
    return jnp.sum(jnp.abs(r[1:-1, 1:-1])) / ((n - 2) * (n - 2))


def relative_residual_norm_compensated(u, f, h: float) -> jnp.ndarray:
    """‖r‖₂/‖f‖₂ with the compensated residual — the benchmark convergence
    metric that stays meaningful at N ≥ 2049 in fp32."""
    r = residual_compensated(u, f, h)
    num = jnp.linalg.norm(r[1:-1, 1:-1])
    den = jnp.linalg.norm(f[1:-1, 1:-1])
    return num / jnp.maximum(den, jnp.asarray(jnp.finfo(u.dtype).tiny, u.dtype))
