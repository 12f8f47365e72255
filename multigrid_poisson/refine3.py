"""3-D deep convergence: multi-word fp32 iterative refinement on cubic grids.

The 2-D refinement subsystem (refine.py) reaches 1e-10-class relative
residuals at production sizes with zero fp64 arrays: the state is a
double-float ("df32", ~2⁻⁴⁸) or triple-word ("tw32", ~2⁻⁷²) fp32 expansion,
the residual is evaluated with error-free-transform (two-sum) chains, and
each outer cycle applies ONE fp32 multigrid V-cycle on the correction
equation. This module is the same structure one dimension up:

    r  = f − A₇·(u₀ + u₁ [+ u₂])   — compensated 7-point stencil sum
    e  ≈ A₇⁻¹ r                    — one v_cycle3
    u += e                          — two-sum accumulation into the words

The 7-point EFT chain has 6 neighbor adds + the −6u diagonal (vs 4 + −4u in
2-D); everything else (word renormalization, the Sterbenz-exact big-term
combination, the interior masking) carries over unchanged. The whole loop —
cycles, compensated norms, convergence test — is one ``lax.while_loop`` on
device.

Floor: eps_state·‖A‖‖u‖/‖f‖ with ‖A‖ ∝ 12/h² — same N² scaling law as the
2-D floor (measured there as 3.9e-24·(N−1)^1.99 for tw32); at 513³ the tw32
floor is ~1e-17, far below any practical tolerance.

No reference counterpart (the reference is strictly 2-D, fp64-host state —
SURVEY.md §2 C15); this is the capability extension that makes the 3-D
stack production-deep, not just demonstration-deep.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from .models.poisson3d import Problem3D, v_cycle3
from .ops.precision import two_sum
from .refine import df_add, tw_add


def _interior_mask3(n: int):
    """Interior mask of a cubic (n, n, n) volume, built from iota
    comparisons inside the trace."""
    z = jnp.arange(n).reshape(n, 1, 1)
    r = jnp.arange(n).reshape(1, n, 1)
    c = jnp.arange(n).reshape(1, 1, n)
    return ((z >= 1) & (z <= n - 2) & (r >= 1) & (r <= n - 2)
            & (c >= 1) & (c <= n - 2))


def _rolled_neighbors3(u):
    return (jnp.roll(u, 1, 0), jnp.roll(u, -1, 0),
            jnp.roll(u, 1, 1), jnp.roll(u, -1, 1),
            jnp.roll(u, 1, 2), jnp.roll(u, -1, 2))


def residual_df3(u_hi, u_lo, f, h: float):
    """Compensated residual of the 3-D double-float pair state.

    r = (Σ₆nb(u_hi+u_lo) − 6(u_hi+u_lo))/h² − f with the u_hi stencil sum in
    error-free two-sums (the cancellation-critical part) and the u_lo sum in
    plain fp32 (already at the eps·|u| level). Interior only, like the 2-D
    residual_df_p."""
    nbs = _rolled_neighbors3(u_hi)
    hi, lo = two_sum(nbs[0], nbs[1])
    for t in nbs[2:]:
        hi, e = two_sum(hi, t)
        lo = lo + e
    for _ in range(6):
        hi, e = two_sum(hi, -u_hi)
        lo = lo + e
    nbl = _rolled_neighbors3(u_lo)
    slo = nbl[0] + nbl[1] + nbl[2] + nbl[3] + nbl[4] + nbl[5] - 6.0 * u_lo
    # h²-scaled, big terms by two-sum: u_lo's stencil sum is rounding noise
    # that can rival h²·f at large N, so hi and h²·f need not be within a
    # factor of two (see residual_tw_p)
    h2 = jnp.asarray(h * h, u_hi.dtype)
    inv_h2 = jnp.asarray(1.0 / (h * h), u_hi.dtype)
    r_big, eb = two_sum(hi, -f * h2)
    r = (r_big + ((lo + slo) + eb)) * inv_h2
    return jnp.where(_interior_mask3(u_hi.shape[0]), r,
                     jnp.zeros_like(r))


def _eft_stencil_sum_dd3(u):
    """(hi, lo, lo2) with hi + lo + lo2 ≈ Σ₆ neighbors − 6u to ~eps³: the
    doubly-compensated chain of refine._eft_stencil_sum_dd with the 7-point
    term list."""
    nbs = _rolled_neighbors3(u)
    hi, lo = two_sum(nbs[0], nbs[1])
    lo2 = jnp.zeros_like(hi)
    for term in (nbs[2], nbs[3], nbs[4], nbs[5], -u, -u, -u, -u, -u, -u):
        hi, e = two_sum(hi, term)
        lo, e2 = two_sum(lo, e)
        lo2 = lo2 + e2
    hi, e = two_sum(hi, lo)
    lo, e2 = two_sum(e, lo2)
    return hi, lo, e2


def residual_tw3(u0, u1, u2, f, h: float):
    """Compensated residual of the 3-D triple-word state (the 2-D
    residual_tw_p layout: doubly-compensated u0/u1 chains, plain u2 sum,
    h²-scaled two-sum combination of the large and small terms)."""
    hi0, lo0, m0 = _eft_stencil_sum_dd3(u0)
    hi1, lo1, m1 = _eft_stencil_sum_dd3(u1)
    nb2 = _rolled_neighbors3(u2)
    s2 = nb2[0] + nb2[1] + nb2[2] + nb2[3] + nb2[4] + nb2[5] - 6.0 * u2
    # h²-scaled two-sum combination (see refine.residual_tw_p: u1's
    # rounding-noise stencil sum can rival h²·f, so no Sterbenz shortcut)
    h2 = jnp.asarray(h * h, u0.dtype)
    inv_h2 = jnp.asarray(1.0 / (h * h), u0.dtype)
    r_big, eb = two_sum(hi0, -f * h2)
    t, c = two_sum(lo0, hi1)
    s, es = two_sum(r_big, t)
    t2 = ((lo1 + m0) + (m1 + s2)) + ((c + eb) + es)
    r = (s + t2) * inv_h2
    return jnp.where(_interior_mask3(u0.shape[0]), r,
                     jnp.zeros_like(r))


def relative_residual3_f64(words, f, h: float):
    """‖r‖₂/‖f‖₂ of the 3-D multi-word state Σ ``words``, evaluated in
    float64 (needs ``jax_enable_x64``) as a compensated residual of the
    error-free float64 pair (the 3-D twin of
    refine.relative_residual_f64)."""
    d = jnp.float64
    hi, lo = words[0].astype(d), jnp.zeros(words[0].shape, d)
    for w in words[1:]:
        hi, e = two_sum(hi, w.astype(d))
        lo = lo + e
    hi, lo = two_sum(hi, lo)
    f64 = f.astype(d)
    r = residual_df3(hi, lo, f64, h)
    den = jnp.linalg.norm(jnp.where(_interior_mask3(f.shape[0]), f64, 0.0))
    return jnp.linalg.norm(r) / den


@dataclasses.dataclass
class Refine3Report:
    u: jnp.ndarray                  # best fp32 representation, (n, n, n)
    u_lo: jnp.ndarray               # second word
    rel_residual: float             # compensated ‖r‖₂/‖f‖₂ at exit
    cycles: int
    wall_time_s: float
    error_vs_analytic: Optional[float] = None


class IterativeRefinement3:
    """Solve the 3-D Poisson problem to a relative-residual target.

    ``state`` ∈ {"df32", "tw32"} picks the outer precision (both keep the
    inner V-cycles in fp32)."""

    def __init__(self, problem: Problem3D, n: int, max_cycles: int = 60,
                 state: str = "df32", pre: int = 3, post: int = 3,
                 omega: float = 6.0 / 7.0, dtype=jnp.float32):
        if state not in ("df32", "tw32"):
            raise ValueError(f"unknown state {state!r} (df32 or tw32)")
        self.problem, self.n, self.state = problem, n, state
        self.max_cycles = max_cycles
        self.dtype = dtype
        self.h = 1.0 / (n - 1)
        h = self.h
        self._shape = (n, n, n)

        def res_df(u0, u1, f):
            return residual_df3(u0, u1, f, h)

        def res_tw(u0, u1, u2, f):
            return residual_tw3(u0, u1, u2, f, h)

        def cycle(rhs):
            # correction equation A·e = rhs, zero Dirichlet everywhere
            return v_cycle3(jnp.zeros_like(rhs), rhs, h, pre=pre, post=post,
                            omega=omega)

        def fnorm(f):
            mask = _interior_mask3(n)
            return jnp.linalg.norm(jnp.ravel(jnp.where(mask, f, 0.0)))

        def make_den(f, r0):
            # ‖f‖ normalization; initial residual as the harmonic fallback
            # (same rule as refine.make_den)
            nf = fnorm(f).astype(r0.dtype)
            return jnp.where(nf > 1e-20, nf,
                             jnp.maximum(r0, jnp.asarray(1e-30, r0.dtype)))

        def run_df(u0, u1, f, tol, budget):
            i0, i1 = self.initial_state()
            den = make_den(f, jnp.linalg.norm(jnp.ravel(
                res_df(i0, i1, f))))
            r = res_df(u0, u1, f)

            def step(state_):
                u0, u1, r, _, k = state_
                e = cycle(-r)
                u0, u1 = df_add(u0, u1, e)
                r = res_df(u0, u1, f)
                rel = jnp.linalg.norm(jnp.ravel(r)) / den
                return u0, u1, r, rel, k + 1

            def cond(state_):
                return jnp.logical_and(state_[3] > tol, state_[4] < budget)

            rel0 = (jnp.linalg.norm(jnp.ravel(r)) / den).astype(self.dtype)
            init = (u0, u1, r, rel0, jnp.asarray(0, jnp.int32))
            u0, u1, _, rel, k = lax.while_loop(cond, step, init)
            return u0, u1, rel, k

        def run_tw(u0, u1, u2, f, tol, budget):
            i0, i1 = self.initial_state()
            den = make_den(f, jnp.linalg.norm(jnp.ravel(
                res_tw(i0, i1, jnp.zeros_like(i0), f))))
            r = res_tw(u0, u1, u2, f)

            def step(state_):
                u0, u1, u2, r, _, k = state_
                e = cycle(-r)
                u0, u1, u2 = tw_add(u0, u1, u2, e)
                r = res_tw(u0, u1, u2, f)
                rel = jnp.linalg.norm(jnp.ravel(r)) / den
                return u0, u1, u2, r, rel, k + 1

            def cond(state_):
                return jnp.logical_and(state_[4] > tol, state_[5] < budget)

            rel0 = (jnp.linalg.norm(jnp.ravel(r)) / den).astype(self.dtype)
            init = (u0, u1, u2, r, rel0, jnp.asarray(0, jnp.int32))
            u0, u1, u2, _, rel, k = lax.while_loop(cond, step, init)
            return u0, u1, u2, rel, k

        self._run = jax.jit(run_tw if state == "tw32" else run_df)

    def initial_state(self):
        """(u0, u1): Dirichlet faces + zero interior."""
        u0 = self.problem.boundary_grid(self.n, self.dtype)
        return u0, jnp.zeros_like(u0)

    def init_rhs(self) -> jnp.ndarray:
        return (self.problem.source_grid(self.n, self.dtype)
                + self.problem.boundary_grid(self.n, self.dtype))

    def _fingerprint(self) -> str:
        return (f"refine3/{self.problem.name}/n={self.n}/{self.state}/"
                f"{jnp.dtype(self.dtype).name}")

    def solve(self, tol: float = 1e-8, checkpoints=None,
              checkpoint_chunk: int = 10) -> Refine3Report:
        """Refine to ``tol``. With a ``CheckpointManager`` in ``checkpoints``
        the loop runs in device-side chunks of ``checkpoint_chunk`` cycles,
        persisting (and resuming) the full multi-word state between chunks —
        the same contract as the 2-D IterativeRefinementSolver.solve."""
        f = self.init_rhs()
        u0, u1 = self.initial_state()
        start = time.perf_counter()
        if checkpoints is not None:
            u0, u1, rel, k = self._solve_checkpointed(f, tol, checkpoints,
                                                      checkpoint_chunk)
        elif self.state == "tw32":
            u0, u1, _, rel, k = self._run(u0, u1, jnp.zeros_like(u0), f,
                                          tol, self.max_cycles)
        else:
            u0, u1, rel, k = self._run(u0, u1, f, tol, self.max_cycles)
        rel_f = float(jax.device_get(rel))
        wall = time.perf_counter() - start
        err = None
        if self.problem.analytic is not None:
            ua = self.problem.analytic_grid(self.n, self.dtype)
            err = float(jax.device_get(jnp.mean(jnp.abs(u0 - ua))))
        return Refine3Report(u=u0, u_lo=u1, rel_residual=rel_f,
                             cycles=int(jax.device_get(k)),
                             wall_time_s=wall, error_vs_analytic=err)


    def _solve_checkpointed(self, f, tol, manager, chunk: int):
        """Host-side chunked loop with persistence (utils.checkpoint): both
        the df32 (two-word) and tw32 (three-word) states resume losslessly
        (the npz format keeps all words at full width)."""
        from .utils.checkpoint import SolverState

        is_tw = self.state == "tw32"
        fp = self._fingerprint()
        done = 0
        resumed = manager.latest()
        if (resumed is not None and resumed.meta
                and resumed.meta.get("schedule") == fp
                and resumed.u.shape == self._shape):
            u0 = jnp.asarray(resumed.u)
            u1 = (jnp.asarray(resumed.u_lo) if resumed.u_lo is not None
                  else jnp.zeros_like(u0))
            u2 = (jnp.asarray(resumed.u_lo2) if resumed.u_lo2 is not None
                  else jnp.zeros_like(u0))
            done = resumed.cycle
        else:
            u0, u1 = self.initial_state()
            u2 = jnp.zeros_like(u0)

        rel = None
        while done < self.max_cycles:
            budget = min(chunk, self.max_cycles - done)
            if is_tw:
                u0, u1, u2, rel, k = self._run(u0, u1, u2, f, tol, budget)
                state = SolverState(u=u0, f=f, u_lo=u1, u_lo2=u2, cycle=0,
                                    meta={"schedule": fp, "tol": tol})
            else:
                u0, u1, rel, k = self._run(u0, u1, f, tol, budget)
                state = SolverState(u=u0, f=f, u_lo=u1, cycle=0,
                                    meta={"schedule": fp, "tol": tol})
            done += int(jax.device_get(k))
            state.cycle = done
            manager.maybe_save(state)
            if float(jax.device_get(rel)) <= tol:
                break
        if rel is None:
            # resumed checkpoint already at the cycle budget: a zero-budget
            # run reports the TRUE residual of the restored state
            if is_tw:
                *_, rel, _ = self._run(u0, u1, u2, f, tol, 0)
            else:
                *_, rel, _ = self._run(u0, u1, f, tol, 0)
        return u0, u1, rel, jnp.asarray(done, jnp.int32)


def solve_to_tolerance3(problem: Problem3D, n: int, tol: float = 1e-8,
                        max_cycles: int = 60, state: str = "df32",
                        **kw) -> Refine3Report:
    """One-call driver: 3-D iterative refinement until ‖r‖/‖f‖ ≤ tol."""
    return IterativeRefinement3(problem, n, max_cycles, state, **kw).solve(tol)
