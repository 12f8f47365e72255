"""3-D iterative-refinement (deep convergence) tests.

Mirrors test_refine.py one dimension up: the multi-word fp32 state + fp32
V-cycles reach relative residuals far below the plain-fp32 floor, with the
compensated 7-point residuals validated against an f64 oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import multigrid_poisson as mg
from multigrid_poisson.models import poisson3d as p3
from multigrid_poisson.refine3 import (
    IterativeRefinement3, residual_df3, residual_tw3, solve_to_tolerance3,
)

PROBLEM = p3.REFERENCE_PROBLEM_3D


def _f64_residual(u64, f64, h):
    return np.asarray(p3.residual3(u64, f64, h))


def test_residual_df3_matches_f64_truth(rng):
    n = 33
    h = 1.0 / (n - 1)
    u = rng.standard_normal((n, n, n)).astype(np.float32)
    # a low word ~eps·|u| like a real refinement state
    lo = (rng.standard_normal((n, n, n)) * 1e-8).astype(np.float32)
    f = PROBLEM.source_grid(n, jnp.float32)
    r = np.asarray(residual_df3(jnp.asarray(u), jnp.asarray(lo),
                                f, h))
    truth = _f64_residual(jnp.asarray(u, jnp.float64)
                          + jnp.asarray(lo, jnp.float64),
                          jnp.asarray(f, jnp.float64), h)
    scale = np.abs(truth).max()
    # fp32 two-sum chains: exact to ~eps of the residual magnitude, decades
    # below the naive fp32 evaluation noise (~eps·|u|/h²)
    assert np.abs(r - truth).max() < 2e-7 * scale


def test_residual_tw3_matches_f64_truth(rng):
    n = 33
    h = 1.0 / (n - 1)
    u0 = rng.standard_normal((n, n, n)).astype(np.float32)
    u1 = (rng.standard_normal((n, n, n)) * 1e-8).astype(np.float32)
    u2 = (rng.standard_normal((n, n, n)) * 1e-16).astype(np.float32)
    f = PROBLEM.source_grid(n, jnp.float32)
    r = np.asarray(residual_tw3(*map(jnp.asarray, (u0, u1, u2)), f, h))
    truth = _f64_residual(sum(jnp.asarray(w, jnp.float64)
                              for w in (u0, u1, u2)),
                          jnp.asarray(f, jnp.float64), h)
    scale = np.abs(truth).max()
    assert np.abs(r - truth).max() < 2e-7 * scale


def test_refine3_df32_reaches_1e9():
    rep = solve_to_tolerance3(PROBLEM, 33, tol=1e-9, state="df32")
    assert rep.rel_residual <= 1e-9
    assert rep.cycles < 30
    # discretization floor: mean|u−analytic| ~ C·h²
    assert rep.error_vs_analytic < 4e-3


def test_refine3_tw32_reaches_1e12():
    rep = solve_to_tolerance3(PROBLEM, 33, tol=1e-12, state="tw32",
                              max_cycles=40)
    assert rep.rel_residual <= 1e-12
    assert rep.cycles < 40


def test_refine3_harmonic_boundary_problem():
    rep = solve_to_tolerance3(p3.HARMONIC_PROBLEM_3D, 33, tol=1e-8)
    # harmonic quadratic: discretely exact, so the solve nails the analytic
    # solution to the refinement depth
    assert rep.rel_residual <= 1e-8
    assert rep.error_vs_analytic < 1e-7


def test_refine3_beats_plain_fp32_floor():
    """The refined state's residual lands decades below what a single fp32
    word can represent (the point of the subsystem)."""
    n = 33
    h = 1.0 / (n - 1)
    rep = solve_to_tolerance3(PROBLEM, n, tol=1e-11, state="tw32",
                              max_cycles=40)
    f = (PROBLEM.source_grid(n, jnp.float32)
         + PROBLEM.boundary_grid(n, jnp.float32))
    # residual of the ROUNDED (single-word) state, in f64: the fp32 floor
    r32 = _f64_residual(jnp.asarray(np.asarray(rep.u), jnp.float64),
                        jnp.asarray(f, jnp.float64), h)
    rel32 = np.linalg.norm(r32) / np.linalg.norm(np.asarray(f))
    assert rep.rel_residual <= 1e-11
    assert rep.rel_residual < rel32 / 50.0


def test_refine3_exported():
    assert mg.IterativeRefinement3 is IterativeRefinement3
    assert mg.solve_to_tolerance3 is solve_to_tolerance3


def test_refine3_checkpoint_resume(tmp_path):
    """Chunked solve persists the multi-word state; a fresh solver resumes
    from the checkpoint and finishes without restarting from cycle 0."""
    from multigrid_poisson.utils.checkpoint import CheckpointManager

    n, tol = 33, 1e-11
    # phase 1: budget-capped run that cannot finish
    s1 = IterativeRefinement3(PROBLEM, n, max_cycles=4, state="tw32")
    mgr = CheckpointManager(tmp_path / "ck")
    rep1 = s1.solve(tol, checkpoints=mgr, checkpoint_chunk=2)
    assert rep1.cycles == 4 and rep1.rel_residual > tol
    assert mgr.latest() is not None and mgr.latest().cycle == 4

    # phase 2: resume and finish
    s2 = IterativeRefinement3(PROBLEM, n, max_cycles=40, state="tw32")
    rep2 = s2.solve(tol, checkpoints=mgr, checkpoint_chunk=5)
    assert rep2.rel_residual <= tol
    # cycles counts TOTAL cycles including the resumed ones
    assert rep2.cycles > 4

    # resumed trajectory matches an uninterrupted solve's depth
    rep_ref = IterativeRefinement3(PROBLEM, n, max_cycles=40,
                                   state="tw32").solve(tol)
    assert abs(rep2.cycles - rep_ref.cycles) <= 1


def test_refine3_resume_exhausted_budget_reports_true_residual(tmp_path):
    """Regression: resuming a checkpoint whose cycle count already hit
    max_cycles used to report rel_residual = inf (the loop never ran)."""
    from multigrid_poisson.utils.checkpoint import CheckpointManager

    n = 33
    mgr = CheckpointManager(tmp_path / "ck")
    s1 = IterativeRefinement3(PROBLEM, n, max_cycles=3, state="df32")
    rep1 = s1.solve(1e-13, checkpoints=mgr, checkpoint_chunk=3)
    assert rep1.cycles == 3
    # resume with the SAME exhausted budget: no further cycles possible
    s2 = IterativeRefinement3(PROBLEM, n, max_cycles=3, state="df32")
    rep2 = s2.solve(1e-13, checkpoints=mgr, checkpoint_chunk=3)
    assert np.isfinite(rep2.rel_residual)
    assert rep2.rel_residual == pytest.approx(rep1.rel_residual, rel=1e-3)
