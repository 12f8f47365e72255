"""Iterative-refinement (deep convergence) and full-weighting tests.

The headline property: df32 pair state + fp32 V-cycles reaches 1e-10
relative residual — two orders below the plain-fp32 state floor — without
any fp64 arrays (see refine.py module docstring).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import multigrid_poisson as mg
from multigrid_poisson.grid import level_sizes
from multigrid_poisson.models.problems import sine_problem
from multigrid_poisson.ops import padded as P
from multigrid_poisson.ops.layout import pad_grid, padded_shape
from multigrid_poisson.refine import (
    IterativeRefinementSolver, df_add, residual_df_p, solve_to_tolerance,
)
from multigrid_poisson.solver import SolverConfig

PROBLEM = mg.REFERENCE_PROBLEM


def test_refine_reaches_1e10_default():
    rep = solve_to_tolerance(PROBLEM, 129, tol=1e-10)
    assert rep.rel_residual <= 1e-10
    assert rep.cycles < 20
    # at the discretization floor: mean|u−analytic| ~ C·h²
    assert rep.error_vs_analytic < 5e-6


def test_refine_rbgs_full_weighting():
    n = 129
    prog = mg.v_cycle(n, n_min=5, steps=2, coarse_option=0, coarsen=3)
    cfg = SolverConfig(smoother="rbgs", restriction="full_weighting")
    rep = solve_to_tolerance(PROBLEM, n, tol=1e-10, program=prog, config=cfg)
    assert rep.rel_residual <= 1e-10
    # V(2,2) RB-GS + FW contracts fast (~0.05-0.1/cycle): a deep 1e-10 solve
    # lands within a handful of cycles, comparable to the ω=0.8 Jacobi
    # default (which now runs an aligned odd-halve hierarchy too)
    assert rep.cycles <= 9


def test_refine_nonzero_boundary_problem():
    # u = x+y is harmonic: source 0, boundary x+y, analytic x+y
    prob = mg.models.problems.Problem(
        source=lambda x, y: jnp.zeros_like(x),
        boundary=lambda x, y: x + y,
        analytic=lambda x, y: x + y,
        name="harmonic-linear")
    rep = solve_to_tolerance(prob, 65, tol=1e-9)
    assert rep.rel_residual <= 1e-9 or rep.error_vs_analytic < 1e-6
    assert rep.error_vs_analytic < 1e-5


def test_residual_df_matches_f64_truth(rng):
    n = 257
    spec = mg.GridSpec(n)
    u_hi = PROBLEM.analytic_grid(spec, jnp.float32)
    u_lo = jnp.asarray(rng.standard_normal((n, n)) * 1e-9, jnp.float32)
    f = PROBLEM.source_grid(spec, jnp.float32)
    got = residual_df_p(pad_grid(u_hi), pad_grid(u_lo), pad_grid(f),
                        spec.h, n)[:n, :n]
    U = np.asarray(u_hi, np.float64) + np.asarray(u_lo, np.float64)
    F = np.asarray(f, np.float64)
    truth = np.zeros_like(U)
    truth[1:-1, 1:-1] = (U[:-2, 1:-1] + U[2:, 1:-1] + U[1:-1, :-2]
                         + U[1:-1, 2:] - 4 * U[1:-1, 1:-1]) / spec.h**2 \
        - F[1:-1, 1:-1]
    scale = np.abs(truth).max() + 1.0
    assert np.abs(np.asarray(got, np.float64) - truth).max() < 1e-5 * scale


def test_refine_tw32_reaches_1e13():
    """Triple-word fp32 state: two decades below the df32 floor, still no
    fp64 arrays anywhere."""
    rep = solve_to_tolerance(PROBLEM, 129, tol=1e-13, state="tw32",
                             max_cycles=30)
    assert rep.rel_residual <= 1e-13
    assert rep.cycles < 20


def test_tw_add_exact(rng):
    from multigrid_poisson.refine import tw_add

    u0 = jnp.asarray(rng.standard_normal(200), jnp.float32)
    u1 = jnp.asarray(rng.standard_normal(200) * 1e-8, jnp.float32)
    u2 = jnp.asarray(rng.standard_normal(200) * 1e-16, jnp.float32)
    e = jnp.asarray(rng.standard_normal(200) * 1e-4, jnp.float32)
    a0, a1, a2 = tw_add(u0, u1, u2, e)
    want = (np.asarray(u0, np.longdouble) + np.asarray(u1, np.longdouble)
            + np.asarray(u2, np.longdouble) + np.asarray(e, np.longdouble))
    got = (np.asarray(a0, np.longdouble) + np.asarray(a1, np.longdouble)
           + np.asarray(a2, np.longdouble))
    np.testing.assert_array_equal(got, want)


def test_residual_tw_matches_longdouble_truth():
    from multigrid_poisson.refine import residual_tw_p, tw_add

    n = 257
    spec = mg.GridSpec(n)
    rng = np.random.default_rng(11)
    u0 = PROBLEM.analytic_grid(spec, jnp.float32)
    u1 = jnp.asarray(rng.standard_normal((n, n)) * 1e-9, jnp.float32)
    u2 = jnp.asarray(rng.standard_normal((n, n)) * 1e-17, jnp.float32)
    f = PROBLEM.source_grid(spec, jnp.float32)
    got = residual_tw_p(pad_grid(u0), pad_grid(u1), pad_grid(u2),
                        pad_grid(f), spec.h, n)[:n, :n]
    U = (np.asarray(u0, np.longdouble) + np.asarray(u1, np.longdouble)
         + np.asarray(u2, np.longdouble))
    F = np.asarray(f, np.longdouble)
    truth = np.zeros_like(U)
    truth[1:-1, 1:-1] = (U[:-2, 1:-1] + U[2:, 1:-1] + U[1:-1, :-2]
                         + U[1:-1, 2:] - 4 * U[1:-1, 1:-1]) / np.longdouble(spec.h)**2 \
        - F[1:-1, 1:-1]
    err = np.abs(np.asarray(got, np.longdouble) - truth).max()
    # two error regimes: ~eps relative to the (large, unconverged) residual
    # of this artificial state, plus a tiny absolute evaluation floor — the
    # floor is what the 1e-10-relative deep solves rely on
    bound = max(1e-5 * float(np.abs(truth).max()), 1e-12)
    assert err < bound


def test_rel_residual_normalized_by_f_when_source_nonzero():
    """Mixed problem (nonzero source AND boundary): the convergence test must
    normalize by ‖f‖, not by the (huge) initial-state residual — otherwise
    the solver stops orders of magnitude early while reporting success."""
    prob = mg.models.problems.Problem(
        source=lambda x, y: -2.0 * (y * (1 - y) + x * (1 - x)),
        boundary=lambda x, y: x + y,
        analytic=lambda x, y: x * (1 - x) * y * (1 - y) + x + y,
        name="mixed")
    n = 65
    rep = solve_to_tolerance(prob, n, tol=1e-9)
    # independently recompute ‖r‖/‖f‖ from the returned state
    from multigrid_poisson.refine import residual_df_p

    spec = mg.GridSpec(n)
    f = pad_grid(prob.source_grid(spec, jnp.float32)
                 + prob.boundary_grid(spec, jnp.float32))
    r = residual_df_p(pad_grid(rep.u), pad_grid(rep.u_lo), f, spec.h, n)
    from multigrid_poisson.ops.layout import interior_mask

    fn = float(jnp.linalg.norm(
        jnp.ravel(f * interior_mask(n, f.shape, jnp.float32))))
    true_rel = float(jnp.linalg.norm(jnp.ravel(r))) / fn
    assert true_rel <= 1.5e-9          # really converged w.r.t. ‖f‖
    assert rep.rel_residual == pytest.approx(true_rel, rel=0.2)


def test_tw32_checkpoint_resume_keeps_all_words(tmp_path):
    """tw32 chunked persistence: all three state words survive the resume,
    so the deep tolerance is still reachable after an interruption."""
    from multigrid_poisson.refine import IterativeRefinementSolver
    from multigrid_poisson.utils.checkpoint import CheckpointManager

    n, tol = 65, 1e-13
    mgr = CheckpointManager(tmp_path / "ck")
    s1 = IterativeRefinementSolver(PROBLEM, n, state="tw32")
    s1.max_cycles = 4                       # simulated preemption
    rep1 = s1.solve(tol, checkpoints=mgr, checkpoint_chunk=4)
    assert rep1.rel_residual > tol
    saved = mgr.latest()
    assert saved is not None and saved.u_lo2 is not None

    s2 = IterativeRefinementSolver(PROBLEM, n, state="tw32")
    rep2 = s2.solve(tol, checkpoints=mgr, checkpoint_chunk=6)
    assert rep2.rel_residual <= tol          # deep target reached post-resume


def test_f64_checkpoint_resume_keeps_full_width(tmp_path):
    """f64 chunked persistence (the round-1 NotImplementedError): the state
    saves at full f64 width and the deep tolerance is reachable after an
    interrupted run resumes."""
    from multigrid_poisson.refine import IterativeRefinementSolver
    from multigrid_poisson.utils.checkpoint import CheckpointManager

    n, tol = 65, 1e-12
    mgr = CheckpointManager(tmp_path / "ck")
    s1 = IterativeRefinementSolver(PROBLEM, n, state="f64")
    s1.max_cycles = 4                       # simulated preemption
    rep1 = s1.solve(tol, checkpoints=mgr, checkpoint_chunk=4)
    assert rep1.rel_residual > tol
    saved = mgr.latest()
    assert saved is not None and saved.u.dtype == np.float64

    s2 = IterativeRefinementSolver(PROBLEM, n, state="f64")
    rep2 = s2.solve(tol, checkpoints=mgr, checkpoint_chunk=6)
    assert rep2.rel_residual <= tol          # deep target reached post-resume
    assert rep2.cycles > 4                   # resumed cycle counter carried


def test_fw_misalignment_raises_in_both_engines():
    cfg = SolverConfig(smoother="rbgs", restriction="full_weighting")
    prog = mg.v_cycle(65, n_min=8, steps=2, coarsen=1)   # 65 -> 32: misaligned
    with pytest.raises(ValueError, match="full_weighting"):
        mg.solve(PROBLEM, prog, cfg)
    with pytest.raises(ValueError, match="full_weighting"):
        from multigrid_poisson.compiled import compile_program
        cc = compile_program(prog, PROBLEM, cfg, donate=False)
        u, f = cc.init()
        cc(u, f)


def test_compiled_iterate_converges():
    from multigrid_poisson.compiled import compile_program
    from multigrid_poisson.ops.stencils import mean_abs_error

    prog = mg.v_cycle(65, n_min=8, steps=3, coarse_option=0)
    cc = compile_program(prog, PROBLEM, donate=False)
    u, f = cc.init()
    run5 = cc.iterate(5)
    u5 = cc.unpad(run5(u, f))
    ua = PROBLEM.analytic_grid(cc.finest_spec, jnp.float32)
    one = cc.unpad(cc(u, f)[0])
    # 5 chained cycles must beat 1 cycle (warm restart actually chains)
    assert float(mean_abs_error(u5, ua)) < float(mean_abs_error(one, ua)) / 5


def test_df_add_exact(rng):
    hi = jnp.asarray(rng.standard_normal(100), jnp.float32)
    lo = jnp.asarray(rng.standard_normal(100) * 1e-8, jnp.float32)
    e = jnp.asarray(rng.standard_normal(100) * 1e-4, jnp.float32)
    nhi, nlo = df_add(hi, lo, e)
    want = (np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
            + np.asarray(e, np.float64))
    got = np.asarray(nhi, np.float64) + np.asarray(nlo, np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-14)


def test_level_sizes_odd_halve():
    assert level_sizes(257, 5, 3) == [257, 129, 65, 33, 17, 9, 5]
    assert level_sizes(64, 5, 3) == [64, 32, 16, 8]  # works off-by-one too


def test_full_weighting_matches_manual(rng):
    n, m = 65, 33
    raw = np.zeros((n, n), np.float32)
    raw[1:-1, 1:-1] = rng.standard_normal((n - 2, n - 2))
    got = P.full_weighting_restrict_p(pad_grid(jnp.asarray(raw)), n, m,
                                      padded_shape(m))
    want = np.zeros((m, m))
    for i in range(1, m - 1):
        for j in range(1, m - 1):
            ii, jj = 2 * i, 2 * j
            want[i, j] = (4 * raw[ii, jj]
                          + 2 * (raw[ii-1, jj] + raw[ii+1, jj]
                                 + raw[ii, jj-1] + raw[ii, jj+1])
                          + raw[ii-1, jj-1] + raw[ii-1, jj+1]
                          + raw[ii+1, jj-1] + raw[ii+1, jj+1]) / 16.0
    np.testing.assert_allclose(np.asarray(got[:m, :m]), want, atol=1e-6)


def test_full_weighting_misaligned_raises():
    with pytest.raises(ValueError, match="full weighting"):
        P.full_weighting_restrict_p(jnp.zeros(padded_shape(65)), 65, 32,
                                    padded_shape(32))


def test_rbgs_sampling_vs_fw_contraction():
    """The documented pathology: on a 2:1-aligned hierarchy, sampling
    restriction of the one-color RB-GS residual over-corrects (aliased
    checkerboard) while full weighting contracts fast."""
    from functools import partial
    from multigrid_poisson.compiled import _run_traced
    from multigrid_poisson.models.problems import Problem

    n = 65
    h = mg.GridSpec(n).h
    zero_p = Problem(source=lambda x, y: jnp.zeros_like(x))
    prog = mg.v_cycle(n, n_min=5, steps=2, coarse_option=0, coarsen=3)
    raw = np.zeros((n, n), np.float32)
    raw[1:-1, 1:-1] = np.random.default_rng(3).standard_normal((n - 2, n - 2))
    r = pad_grid(jnp.asarray(raw))
    den = float(jnp.linalg.norm(r))

    def contraction(cfg):
        cycle = jax.jit(partial(_run_traced, program=prog, problem=zero_p,
                                config=cfg, policy=None, warm=False))
        e, _ = cycle(jnp.zeros_like(r), r)   # one cycle on ∇²e = r
        return float(jnp.linalg.norm(P.residual_p(e, r, h, n))) / den

    fw = contraction(SolverConfig(smoother="rbgs", restriction="full_weighting"))
    samp = contraction(SolverConfig(smoother="rbgs"))
    assert fw < 0.1          # textbook V(2,2) RB-GS
    assert samp > 5 * fw     # sampling pathology is real and measurable


def test_bf16_inner_cycles_converge():
    """inner_dtype=bfloat16: correction cycles in bf16 still converge the
    fp32-pair outer state (contraction degrades ~0.03 -> ~0.4/cycle — the
    measured reason bf16 inner cycles are NOT the default)."""
    s = IterativeRefinementSolver(mg.REFERENCE_PROBLEM, 129, state="df32",
                                  max_cycles=40, inner_dtype=jnp.bfloat16)
    rep = s.solve(tol=1e-7)
    assert rep.rel_residual < 1e-7
    ref = IterativeRefinementSolver(mg.REFERENCE_PROBLEM, 129, state="df32",
                                    max_cycles=40).solve(tol=1e-7)
    assert rep.error_vs_analytic == pytest.approx(ref.error_vs_analytic,
                                                  rel=1e-3)
