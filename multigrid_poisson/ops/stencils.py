"""Core 5-point stencil operations: residual, smoothers, error metrics.

These are the pure-jnp "oracle" implementations of the reference's numerical
ops (the role the CPU code plays for the CUDA kernels in the reference's
testFunction/ harnesses). They are dtype-polymorphic, shape-static, jittable,
and differentiable; the padded-layout ops in ``ops.padded`` that the
compiled engine runs are tested against them.

Reference semantics reproduced here:
  * residual  — getResidual, MG_solver_CPU.cpp:554-564
  * Jacobi smoother — doSmoothing, MG_solver_CPU.cpp:573-604. Despite the
    "Gauss-Seidel" comment, both colored half-sweeps read the *old* iterate,
    so it is plain unweighted Jacobi; we additionally expose the damping
    factor ``omega`` (2/3 is the textbook choice for multigrid smoothing).
  * red-black Gauss-Seidel sweep — GaussSeidel inner loop,
    MG_solver_CPU.cpp:996-1055 (even half-sweep then odd half-sweep, the odd
    sweep reading the freshly updated even values).
  * smoothing error — MG_solver_CPU.cpp:607-622. NOTE the reference has a
    color bug: both partial sums use the same parity predicate, so the
    even-color interior points are counted twice and the odd color never
    (documented in SURVEY.md §5). ``smoothing_error(..., compat=True)``
    reproduces that metric bit-for-bit in exact arithmetic so trigger-mode
    schedules behave identically; ``compat=False`` is the clean
    mean-|residual|-over-interior metric.

Layout: arrays are (n, n), indexed [iy, ix]; boundaries are never modified by
smoothers and the residual is defined as 0 there.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _nb_sum(u: jnp.ndarray) -> jnp.ndarray:
    """Sum of the four neighbors for every interior point; shape (n-2, n-2)."""
    return u[:-2, 1:-1] + u[2:, 1:-1] + u[1:-1, :-2] + u[1:-1, 2:]


def residual(u: jnp.ndarray, f: jnp.ndarray, h: float) -> jnp.ndarray:
    """r = ∇²u − f on the interior, 0 on the boundary.

    ∇²u is the standard 5-point stencil (u_E + u_W + u_N + u_S − 4u_C)/h².
    Matches getResidual (MG_solver_CPU.cpp:554-564).
    """
    inv_h2 = jnp.asarray(1.0 / (h * h), u.dtype)
    r_int = inv_h2 * (_nb_sum(u) - 4.0 * u[1:-1, 1:-1]) - f[1:-1, 1:-1]
    return jnp.zeros_like(u).at[1:-1, 1:-1].set(r_int)


def interior_color_masks(n: int, dtype=jnp.bool_) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(even, odd) checkerboard masks over the (n-2, n-2) interior.

    "Even" means (iy + ix) % 2 == 0 in full-grid coordinates — the color the
    reference's smoother error counts (predicate ``j = i%2==0 ? 2 : 1``,
    MG_solver_CPU.cpp:610) and its GS even chestbox (MG_solver_CPU.cpp:971-980).
    """
    iy = jax.lax.broadcasted_iota(jnp.int32, (n - 2, n - 2), 0) + 1
    ix = jax.lax.broadcasted_iota(jnp.int32, (n - 2, n - 2), 1) + 1
    even = ((iy + ix) % 2 == 0).astype(dtype)
    return even, ((iy + ix) % 2 == 1).astype(dtype)


def jacobi_sweep(u: jnp.ndarray, f: jnp.ndarray, h: float, omega: float = 1.0) -> jnp.ndarray:
    """One (damped) Jacobi sweep; boundary untouched.

    u_new = u + ω/4 · (Σ neighbors − 4u − h²f) — the reference's increment form
    (MG_solver_CPU.cpp:590-603) with ω = 1.
    """
    h2 = jnp.asarray(h * h, u.dtype)
    incr = 0.25 * (_nb_sum(u) - 4.0 * u[1:-1, 1:-1] - h2 * f[1:-1, 1:-1])
    return u.at[1:-1, 1:-1].add(jnp.asarray(omega, u.dtype) * incr)


def redblack_gs_sweep(u: jnp.ndarray, f: jnp.ndarray, h: float) -> jnp.ndarray:
    """One red-black Gauss-Seidel sweep: even half-sweep, then odd half-sweep.

    Each half-sweep sets u = (Σ neighbors − h²f)/4 on its color; the odd sweep
    sees the updated even values (GaussSeidel, MG_solver_CPU.cpp:996-1055).
    """
    h2 = jnp.asarray(h * h, u.dtype)
    even, odd = interior_color_masks(u.shape[0], u.dtype)

    def half(u, mask):
        val = 0.25 * (_nb_sum(u) - h2 * f[1:-1, 1:-1])
        new_int = mask * val + (1 - mask) * u[1:-1, 1:-1]
        return u.at[1:-1, 1:-1].set(new_int)

    return half(half(u, even), odd)


def smoothing_error(u: jnp.ndarray, f: jnp.ndarray, h: float, compat: bool = True) -> jnp.ndarray:
    """The post-smoothing error metric driving trigger-mode schedules.

    compat=True reproduces MG_solver_CPU.cpp:606-622: sum of |residual| over the
    *even-color* interior points, counted twice (the reference's color bug),
    divided by N². compat=False: mean |residual| over all interior points,
    divided by N² as well (so magnitudes are comparable).

    The third reference metric — the GPU smoother's |ΔU|·4/h² — needs two
    iterates; see ``gpu_smoothing_error``.
    """
    r = residual(u, f, h)
    n = u.shape[0]
    if compat:
        even, _ = interior_color_masks(n, u.dtype)
        s = 2.0 * jnp.sum(jnp.abs(r[1:-1, 1:-1]) * even)
    else:
        s = jnp.sum(jnp.abs(r[1:-1, 1:-1]))
    return s / (n * n)


def gpu_smoothing_error(u_new: jnp.ndarray, u_old: jnp.ndarray, h: float) -> jnp.ndarray:
    """The GPU reference's smoother metric: mean |U_new − U_old|·4/h² over N².

    ker_Smoothing_GPU accumulates |U[i] − U0[i]|·4/h² over the interior of the
    *final* sweep's ping-pong pair and the host divides by N²
    (MG_solver_GPU.cu:633, 1266-1272) — a different quantity from both CPU
    variants above: for ω-damped Jacobi it equals ω·mean|residual(u_old)|.
    """
    n = u_new.shape[0]
    d = jnp.abs(u_new[1:-1, 1:-1] - u_old[1:-1, 1:-1])
    scale = jnp.asarray(4.0 / (h * h), u_new.dtype)
    return jnp.sum(d) * scale / (n * n)


@partial(jax.jit, static_argnames=("h", "steps", "omega", "compat", "smoother"))
def smooth(
    u: jnp.ndarray,
    f: jnp.ndarray,
    h: float,
    steps: int,
    omega: float = 1.0,
    compat: bool = True,
    smoother: str = "jacobi",
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Run ``steps`` smoothing sweeps and return (u, error).

    The fused Jacobi path mirrors doSmoothing (MG_solver_CPU.cpp:573-625):
    ``steps`` sweeps, then the smoothing-error metric. ``smoother`` selects
    "jacobi" (reference default) or "rbgs" (red-black Gauss-Seidel, a strictly
    better multigrid smoother that the reference only uses as a coarse solver).
    ``compat`` selects the metric: True (CPU color-bugged), False (clean), or
    "gpu" (the GPU ping-pong |ΔU|·4/h² of the final sweep,
    MG_solver_GPU.cu:633).
    """
    sweep = {"jacobi": partial(jacobi_sweep, omega=omega),
             "rbgs": redblack_gs_sweep}[smoother]
    if compat == "gpu":
        if steps == 0:
            # the reference never calls doSmoothing_GPU with step=0 (its err
            # buffer would be uninitialized); define the no-sweep metric as 0
            return u, jnp.zeros((), u.dtype)
        prev, u = jax.lax.fori_loop(
            0, steps - 1, lambda _, c: (c[1], sweep(c[1], f, h)),
            (u, sweep(u, f, h)))
        return u, gpu_smoothing_error(u, prev, h)
    u = jax.lax.fori_loop(0, steps, lambda _, v: sweep(v, f, h), u)
    return u, smoothing_error(u, f, h, compat=compat)


def add_correction(u: jnp.ndarray, correction: jnp.ndarray) -> jnp.ndarray:
    """u += correction, elementwise (doGridAddition, MG_solver_CPU.cpp:566-571)."""
    return u + correction


def mean_abs_interior_residual(u: jnp.ndarray, f: jnp.ndarray, h: float) -> jnp.ndarray:
    """Mean |residual| over the (n-2)² interior points.

    The reference CPU exact solver's convergence metric (MG_solver_CPU.cpp:1043-1059).
    """
    r = residual(u, f, h)
    n = u.shape[0]
    return jnp.sum(jnp.abs(r[1:-1, 1:-1])) / ((n - 2) * (n - 2))


def mean_abs_error(u: jnp.ndarray, reference_u: jnp.ndarray) -> jnp.ndarray:
    """Mean |u − u_ref| over all N² points (final report metric, MG_solver_CPU.cpp:438-445)."""
    return jnp.mean(jnp.abs(u - reference_u))


def relative_residual_norm(u: jnp.ndarray, f: jnp.ndarray, h: float) -> jnp.ndarray:
    """‖r‖₂ / ‖f‖₂ over the interior — the headline convergence metric for benchmarks."""
    r = residual(u, f, h)
    num = jnp.linalg.norm(r[1:-1, 1:-1])
    den = jnp.linalg.norm(f[1:-1, 1:-1])
    return num / jnp.maximum(den, jnp.asarray(jnp.finfo(u.dtype).tiny, u.dtype))
