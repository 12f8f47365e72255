"""3-D geometric multigrid scaffold (capability extension beyond the 2-D
reference).

The reference (cindytsai/multigrid_poisson_solver) is strictly 2-D; this
module demonstrates that the framework's design generalizes: the 7-point
stencil ops are the same roll/mask patterns as ops.stencils, transfer
operators stay separable (three 1-D passes), and a V-cycle composes them
recursively. Everything here is plain jittable jnp, which XLA fuses.

Grids are vertex-centered (n, n, n) arrays over [0, 1]³ with Dirichlet
boundaries; hierarchies use the odd-halve rule n → (n+1)/2 (2:1 vertex
alignment, the rule full-weighting restriction needs).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache, partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np


def _nb_sum3(u):
    """Sum of the six face neighbors for every interior point."""
    return (u[:-2, 1:-1, 1:-1] + u[2:, 1:-1, 1:-1]
            + u[1:-1, :-2, 1:-1] + u[1:-1, 2:, 1:-1]
            + u[1:-1, 1:-1, :-2] + u[1:-1, 1:-1, 2:])


def residual3(u, f, h: float):
    """r = ∇²u − f (7-point stencil) on the interior, 0 on the boundary."""
    inv_h2 = jnp.asarray(1.0 / (h * h), u.dtype)
    r = inv_h2 * (_nb_sum3(u) - 6.0 * u[1:-1, 1:-1, 1:-1]) - f[1:-1, 1:-1, 1:-1]
    return jnp.zeros_like(u).at[1:-1, 1:-1, 1:-1].set(r)


def jacobi_sweep3(u, f, h: float, omega: float = 0.857):
    """One damped Jacobi sweep (ω = 6/7 is the 3-D analog of the 2-D 0.8:
    it damps the highest-frequency checkerboard mode to |1 − 2ω| ≈ 5/7)."""
    h2 = jnp.asarray(h * h, u.dtype)
    incr = (_nb_sum3(u) - 6.0 * u[1:-1, 1:-1, 1:-1] - h2 * f[1:-1, 1:-1, 1:-1])
    return u.at[1:-1, 1:-1, 1:-1].add(jnp.asarray(omega / 6.0, u.dtype) * incr)


def redblack_gs_sweep3(u, f, h: float):
    """One 3-D red-black Gauss-Seidel sweep: even (i+j+k) half-sweep, then
    odd, the odd half seeing updated even values (3-D analog of the 2-D
    reference's GaussSeidel, MG_solver_CPU.cpp:996-1055; the 7-point stencil
    is 2-colorable just like the 5-point one)."""
    n = u.shape[0]
    h2 = jnp.asarray(h * h, u.dtype)
    ii = jax.lax.broadcasted_iota(jnp.int32, (n - 2,) * 3, 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (n - 2,) * 3, 1)
    kk = jax.lax.broadcasted_iota(jnp.int32, (n - 2,) * 3, 2)
    even = (((ii + jj + kk) + 3) % 2 == 0).astype(u.dtype)  # +3: interior offset

    def half(u, mask):
        val = (_nb_sum3(u) - h2 * f[1:-1, 1:-1, 1:-1]) / 6.0
        new_int = mask * val + (1 - mask) * u[1:-1, 1:-1, 1:-1]
        return u.at[1:-1, 1:-1, 1:-1].set(new_int)

    return half(half(u, even), 1.0 - even)


def smoothing_error3(u, f, h: float) -> jnp.ndarray:
    """Post-smoothing error metric for 3-D trigger schedules: mean |residual|
    over N³ (the 2-D reference's *clean* metric one dimension up — its CPU
    color-bug is 2-D-specific and is not reproduced here)."""
    n = u.shape[0]
    r = residual3(u, f, h)
    return jnp.sum(jnp.abs(r[1:-1, 1:-1, 1:-1])) / (n ** 3)


def gpu_smoothing_error3(u_new, u_old, h: float) -> jnp.ndarray:
    """3-D analog of the GPU reference's smoother metric (|ΔU|·(2d)/h² of the
    final ping-pong pair, MG_solver_GPU.cu:633): mean |U_new − U_old|·6/h²."""
    n = u_new.shape[0]
    d = jnp.abs(u_new[1:-1, 1:-1, 1:-1] - u_old[1:-1, 1:-1, 1:-1])
    return jnp.sum(d) * jnp.asarray(6.0 / (h * h), u_new.dtype) / (n ** 3)


@partial(jax.jit, static_argnames=("h", "steps", "omega", "compat", "smoother"))
def smooth3(u, f, h: float, steps: int, omega: float = 0.857,
            compat="clean", smoother: str = "jacobi"):
    """``steps`` 3-D smoothing sweeps, then the error metric — the 3-D
    member of the ops.stencils.smooth family (same signature contract)."""
    sweep = {"jacobi": partial(jacobi_sweep3, omega=omega),
             "rbgs": redblack_gs_sweep3}[smoother]
    if compat == "gpu":
        if steps == 0:
            return u, jnp.zeros((), u.dtype)
        prev, u = jax.lax.fori_loop(
            0, steps - 1, lambda _, c: (c[1], sweep(c[1], f, h)),
            (u, sweep(u, f, h)))
        return u, gpu_smoothing_error3(u, prev, h)
    u = jax.lax.fori_loop(0, steps, lambda _, v: sweep(v, f, h), u)
    return u, smoothing_error3(u, f, h)


@partial(jax.jit, static_argnames=("h", "trigger", "omega", "compat",
                                   "smoother", "max_sweeps"))
def trigger_smooth3(u, f, h: float, trigger: float, omega: float, compat,
                    smoother: str, max_sweeps: int):
    """Error-triggered 3-D smoothing (device-side while_loop, same slope-stop
    rule as the 2-D engines: sweep while |err_k − err_{k−1}| > trigger)."""
    sweep = {"jacobi": partial(jacobi_sweep3, omega=omega),
             "rbgs": redblack_gs_sweep3}[smoother]

    def err_of(u_new, u_old):
        if compat == "gpu":
            return gpu_smoothing_error3(u_new, u_old, h)
        return smoothing_error3(u_new, f, h)

    u0 = u
    u = sweep(u, f, h)
    err0 = err_of(u, u0)

    def cond(state):
        _, _, slope, k = state
        return jnp.logical_and(slope > trigger, k < max_sweeps)

    def body(state):
        u, prev, _, k = state
        u_new = sweep(u, f, h)
        err = err_of(u_new, u)
        return u_new, err, jnp.abs(err - prev), k + 1

    init = (u, err0, jnp.asarray(trigger + 1.0, err0.dtype),
            jnp.asarray(1, jnp.int32))
    u, err, _, k = jax.lax.while_loop(cond, body, init)
    return u, err, k


@lru_cache(maxsize=8)
def _laplacian3_inverse(n: int, h: float, dtype_name: str) -> np.ndarray:
    """Cached f64 inverse of the interior 7-point Laplacian on an n³ grid
    ((n−2)³ unknowns; the 3-D analog of ops.coarse.dense_solve's cached
    InverseMatrix redesign — one HIGHEST-precision matmul applies it).

    Caches a HOST numpy array, never a jnp array: a jnp constant built
    inside one jit sub-trace and replayed from the cache inside a sibling
    sub-trace escapes its trace scope (UnexpectedTracerError — hit when two
    compiled3 engines sharing the cache were traced in one outer jit)."""
    m = n - 2
    if m ** 3 > 4096:
        raise ValueError(
            f"dense 3-D coarse solve capped at 4096 unknowns, got {m ** 3} "
            f"(n={n}); use the red-black GS option for bigger coarse grids")
    h = float(h)                     # never a tracer in the cache key
    eye = np.eye(m, dtype=np.float64)
    lap1 = (np.diag(np.full(m - 1, 1.0), 1) + np.diag(np.full(m - 1, 1.0), -1)
            - 2.0 * eye)
    a = (np.kron(np.kron(lap1, eye), eye) + np.kron(np.kron(eye, lap1), eye)
         + np.kron(np.kron(eye, eye), lap1)) / (h * h)
    return np.linalg.inv(a).astype(dtype_name)


def dense_solve3(f, h: float):
    """Exact coarse solve via the cached dense inverse (CoarseSolve option 0).

    Boundary convention matches the 2-D engine: ``f`` carries Dirichlet
    values on its border and the RHS inside; the interior system absorbs the
    boundary terms into the RHS."""
    n = f.shape[0]
    inv = jnp.asarray(_laplacian3_inverse(n, float(h),
                                          jnp.dtype(f.dtype).name))
    bc = jnp.where(jnp.zeros((n,) * 3, bool).at[1:-1, 1:-1, 1:-1].set(True),
                   jnp.zeros_like(f), f)
    # move boundary contributions to the RHS: for interior cells adjacent to
    # the boundary, A·u = f − (boundary neighbors)/h²
    rhs = (f[1:-1, 1:-1, 1:-1]
           - _nb_sum3(bc) / jnp.asarray(h * h, f.dtype))
    sol = jnp.dot(inv.astype(f.dtype), rhs.reshape(-1),
                  precision=jax.lax.Precision.HIGHEST,
                  preferred_element_type=f.dtype)
    m = n - 2
    return bc.at[1:-1, 1:-1, 1:-1].set(sol.reshape(m, m, m))


@partial(jax.jit, static_argnames=("h", "target", "norm", "max_iters"))
def gauss_seidel_solve3(f, h: float, target: float, norm: str = "interior",
                        max_iters: int = 100_000):
    """Red-black GS at the coarsest 3-D level until mean |residual| ≤ target
    (CoarseSolve options 1/2), with the 2-D engine's stagnation stop.

    Starts from the Dirichlet data (zero interior), like the reference's
    exact solvers (MG_solver_CPU.cpp:993)."""
    n = f.shape[0]
    mask = jnp.zeros((n,) * 3, bool).at[1:-1, 1:-1, 1:-1].set(True)
    u0 = jnp.where(mask, jnp.zeros_like(f), f)
    denom = (n - 2) ** 3 if norm == "interior" else n ** 3

    def err_of(u):
        r = residual3(u, f, h)
        return jnp.sum(jnp.abs(r[1:-1, 1:-1, 1:-1])) / denom

    def cond(state):
        _, err, prev, k = state
        improving = err < prev * (1.0 - 1e-7)
        return jnp.logical_and(err > target,
                               jnp.logical_and(improving, k < max_iters))

    def body(state):
        u, err, _, k = state
        u = redblack_gs_sweep3(u, f, h)
        return u, err_of(u), err, k + 1

    u = redblack_gs_sweep3(u0, f, h)
    err = err_of(u)
    state = (u, err, jnp.asarray(jnp.inf, err.dtype), jnp.asarray(1, jnp.int32))
    u, err, _, k = jax.lax.while_loop(cond, body, state)
    return u, err, k


def restrict3(d, m: int):
    """2:1 full-weighting restriction (separable [¼,½,¼] then even sample),
    zero boundary — requires n == 2m − 1."""
    n = d.shape[0]
    if n != 2 * m - 1:
        raise ValueError(f"need n == 2m-1, got {n} -> {m}")

    def fw_axis(a, axis):
        lo = jnp.roll(a, 1, axis)
        hi = jnp.roll(a, -1, axis)
        return 0.25 * lo + 0.5 * a + 0.25 * hi

    s = fw_axis(fw_axis(fw_axis(d, 0), 1), 2)
    out = s[::2, ::2, ::2]
    z = jnp.zeros_like(out)
    mask = jnp.zeros((m, m, m), bool).at[1:-1, 1:-1, 1:-1].set(True)
    return jnp.where(mask, out, z)


def prolong3(uc, n: int):
    """2:1 trilinear prolongation (separable linear interpolation)."""
    m = uc.shape[0]
    if n != 2 * m - 1:
        raise ValueError(f"need n == 2m-1, got {m} -> {n}")

    def expand_axis(a, axis):
        # even fine points copy; odd points average neighbors
        mvd = jnp.moveaxis(a, axis, 0)
        odd = 0.5 * (mvd[:-1] + mvd[1:])
        out = jnp.zeros((2 * mvd.shape[0] - 1,) + mvd.shape[1:], a.dtype)
        out = out.at[::2].set(mvd).at[1::2].set(odd)
        return jnp.moveaxis(out, 0, axis)

    return expand_axis(expand_axis(expand_axis(uc, 0), 1), 2)


@dataclasses.dataclass(frozen=True)
class Problem3D:
    """∇²u = f on [0,1]³ with Dirichlet boundary."""

    source: Callable
    boundary: Optional[Callable] = None
    analytic: Optional[Callable] = None
    name: str = "custom3d"

    def _grid(self, fn, n: int, dtype):
        x = jnp.linspace(0.0, 1.0, n, dtype=dtype)
        X, Y, Z = jnp.meshgrid(x, x, x, indexing="ij")
        return fn(X, Y, Z).astype(dtype)

    def source_grid(self, n, dtype=jnp.float32):
        return self._grid(self.source, n, dtype)

    def boundary_grid(self, n, dtype=jnp.float32):
        if self.boundary is None:
            return jnp.zeros((n, n, n), dtype)
        g = self._grid(self.boundary, n, dtype)
        mask = jnp.zeros((n, n, n), bool).at[1:-1, 1:-1, 1:-1].set(True)
        return jnp.where(mask, jnp.zeros_like(g), g)

    def analytic_grid(self, n, dtype=jnp.float32):
        assert self.analytic is not None
        return self._grid(self.analytic, n, dtype)


# manufactured 3-D analog of the reference's 2-D problem
REFERENCE_PROBLEM_3D = Problem3D(
    source=lambda x, y, z: -3.0 * (2 * jnp.pi) ** 2
    * jnp.sin(2 * jnp.pi * x) * jnp.sin(2 * jnp.pi * y)
    * jnp.sin(2 * jnp.pi * z),
    analytic=lambda x, y, z: jnp.sin(2 * jnp.pi * x)
    * jnp.sin(2 * jnp.pi * y) * jnp.sin(2 * jnp.pi * z),
    name="sine3d",
)


# polynomial family: exact solution is a degree-2-per-axis polynomial, so
# the discrete solution is h-exact (useful for order checks)
POLY_PROBLEM_3D = Problem3D(
    source=lambda x, y, z: -2.0 * (y * (1 - y) * z * (1 - z)
                                   + x * (1 - x) * z * (1 - z)
                                   + x * (1 - x) * y * (1 - y)),
    analytic=lambda x, y, z: x * (1 - x) * y * (1 - y) * z * (1 - z),
    name="poly3d",
)

# boundary-driven harmonic problem: f = 0, u = the harmonic extension
HARMONIC_PROBLEM_3D = Problem3D(
    source=lambda x, y, z: jnp.zeros_like(x),
    boundary=lambda x, y, z: x * x - 0.5 * y * y - 0.5 * z * z,
    analytic=lambda x, y, z: x * x - 0.5 * y * y - 0.5 * z * z,
    name="harmonic3d",
)

BUILTIN_PROBLEMS_3D = {
    "reference": REFERENCE_PROBLEM_3D,
    "poly": POLY_PROBLEM_3D,
    "harmonic": HARMONIC_PROBLEM_3D,
}


def _sizes(n_max: int, n_min: int) -> list[int]:
    sizes = [n_max]
    while sizes[-1] > n_min and (sizes[-1] + 1) % 2 == 0 and sizes[-1] >= 5:
        m = (sizes[-1] + 1) // 2
        if m < n_min or m == sizes[-1]:
            break
        sizes.append(m)
    return sizes


@partial(jax.jit, static_argnames=("h", "n_min", "pre", "post",
                                   "coarse_sweeps", "omega"))
def v_cycle3(u, f, h: float, n_min: int = 5, pre: int = 2, post: int = 2,
             coarse_sweeps: int = 50, omega: float = 0.857):
    """One recursive 3-D V-cycle (coarsest level relaxed to convergence)."""
    n = u.shape[0]
    sizes = _sizes(n, n_min)

    def smooth(u, f, h, k):
        for _ in range(k):
            u = jacobi_sweep3(u, f, h, omega)
        return u

    def neg_residual(u, f, h):
        return -residual3(u, f, h)

    def run(u, f, h, depth):
        n = u.shape[0]
        if depth == len(sizes) - 1:
            return smooth(u, f, h, coarse_sweeps)
        u = smooth(u, f, h, pre)
        m = sizes[depth + 1]
        fc = restrict3(neg_residual(u, f, h), m)
        ec = run(jnp.zeros((m, m, m), u.dtype), fc, 2 * h, depth + 1)
        u = u + prolong3(ec, n)
        u = u.at[0].set(0).at[-1].set(0)  # prolongation keeps bounds 0 anyway
        return smooth(u, f, h, post)

    return run(u, f, h, 0)


def solve3(problem: Problem3D, n: int, cycles: int = 10,
           dtype=jnp.float32):
    """Chained 3-D V-cycles; returns (u, mean |u − analytic| if available)."""
    h = 1.0 / (n - 1)
    f = problem.source_grid(n, dtype) + problem.boundary_grid(n, dtype)
    u = problem.boundary_grid(n, dtype)

    @jax.jit
    def iterate(u, f):
        return jax.lax.fori_loop(
            0, cycles, lambda i, v: v_cycle3(v, f, h), u)

    u = iterate(u, f)
    err = None
    if problem.analytic is not None:
        err = float(jnp.mean(jnp.abs(u - problem.analytic_grid(n, dtype))))
    return u, err
