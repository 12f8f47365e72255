"""3-D schedule engine: zoom3, coarse solvers, and Cycle.txt-driven solves."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import multigrid_poisson as mg
from multigrid_poisson.models import poisson3d as p3
from multigrid_poisson.ops.zoom import zoom3
from multigrid_poisson.solver import SolverConfig
from multigrid_poisson.solver3 import Solver3D


def _grid3(fn, n, dtype=jnp.float32):
    x = jnp.linspace(0.0, 1.0, n, dtype=dtype)
    X, Y, Z = jnp.meshgrid(x, x, x, indexing="ij")
    return fn(X, Y, Z).astype(dtype)


# --- zoom3 --------------------------------------------------------------------

def test_zoom3_exact_on_trilinear():
    """Trilinear resampling reproduces any trilinear function exactly."""
    fn = lambda x, y, z: 1.0 + 2 * x - 3 * y + 0.5 * z + x * y - y * z + x * y * z
    for n_src, n_dst in [(9, 17), (17, 9), (9, 12), (13, 7)]:
        got = zoom3(_grid3(fn, n_src), n_dst)
        want = _grid3(fn, n_dst)
        assert float(jnp.abs(got - want).max()) < 1e-5, (n_src, n_dst)


def test_zoom3_matches_prolong3_on_aligned():
    """2:1 trilinear prolongation is the aligned special case of zoom3."""
    uc = jax.random.normal(jax.random.PRNGKey(0), (9, 9, 9))
    got = zoom3(uc, 17)
    want = p3.prolong3(uc, 17)
    assert float(jnp.abs(got - want).max()) < 1e-6


def test_zoom3_zero_boundary():
    src = jnp.ones((9, 9, 9))
    out = zoom3(src, 13, zero_boundary=True)
    assert float(jnp.abs(out[0]).max()) == 0.0
    assert float(jnp.abs(out[:, -1]).max()) == 0.0
    assert float(jnp.abs(out[:, :, 0]).max()) == 0.0
    assert float(out[1:-1, 1:-1, 1:-1].min()) > 0.99


# --- coarse solvers -----------------------------------------------------------

def _poisson_fixture(n, problem=p3.REFERENCE_PROBLEM_3D):
    h = 1.0 / (n - 1)
    f = problem.source_grid(n) + problem.boundary_grid(n)
    return f, h


def test_dense_solve3_solves_discrete_system():
    n = 9
    f, h = _poisson_fixture(n)
    u = p3.dense_solve3(f, h)
    r = p3.residual3(u, f, h)
    assert float(jnp.abs(r).max()) < 1e-3 * float(jnp.abs(f).max())


def test_dense_solve3_boundary_values():
    """Dirichlet data on the border of f is carried into u."""
    n = 7
    f, h = _poisson_fixture(n, p3.HARMONIC_PROBLEM_3D)
    u = p3.dense_solve3(f, h)
    ua = p3.HARMONIC_PROBLEM_3D.analytic_grid(n)
    # the harmonic solution is per-axis quadratic -> discretely exact
    assert float(jnp.abs(u - ua).max()) < 1e-4


def test_gauss_seidel_solve3_reaches_target():
    n = 9
    f, h = _poisson_fixture(n)
    u, err, iters = p3.gauss_seidel_solve3(f.astype(jnp.float64), h, 1e-7)
    assert float(err) <= 1e-7
    assert int(iters) < 10_000
    r = p3.residual3(u, f.astype(jnp.float64), h)
    interior = (n - 2) ** 3
    assert float(jnp.sum(jnp.abs(r[1:-1, 1:-1, 1:-1]))) / interior <= 1.5e-7


def test_rbgs3_matches_dense():
    n = 9
    f, h = _poisson_fixture(n)
    ud = p3.dense_solve3(f.astype(jnp.float64), h)
    ug, _, _ = p3.gauss_seidel_solve3(f.astype(jnp.float64), h, 1e-12)
    assert float(jnp.abs(ud - ug).max()) < 1e-8


# --- schedule-driven solves ---------------------------------------------------

def _vcycle_program(n=17, depth=2, steps=3):
    return mg.v_cycle(n, n_min=max(5, (n - 1) // (2 ** depth) + 1),
                      steps=steps, coarse_target=1e-8)


def test_solver3_vcycle_reference_problem():
    program = mg.v_cycle(17, n_min=5, steps=3, coarse_target=1e-8, coarsen=3)
    cfg = SolverConfig(omega=6.0 / 7.0, collect_node_stats=False)
    report = Solver3D(p3.REFERENCE_PROBLEM_3D, cfg).run(program)
    assert report.u.shape == (17, 17, 17)
    # one V-cycle at h=1/16 on the sine problem: discretization-level error
    assert report.error_vs_analytic < 0.05


def test_solver3_repeat_converges_to_discrete_solution():
    """Chained V-cycles drive the residual toward zero (not just the
    discretization error): check against the dense solve of the same system."""
    program = mg.repeat(mg.v_cycle(9, n_min=5, steps=4, coarse_target=1e-10, coarsen=3), 8)
    cfg = SolverConfig(omega=6.0 / 7.0, dtype=jnp.float64,
                       collect_node_stats=False)
    report = Solver3D(p3.REFERENCE_PROBLEM_3D, cfg).run(program)
    h = 1.0 / 8
    f = (p3.REFERENCE_PROBLEM_3D.source_grid(9, jnp.float64)
         + p3.REFERENCE_PROBLEM_3D.boundary_grid(9, jnp.float64))
    u_exact = p3.dense_solve3(f, h)
    # measured contraction ~1/36 per cycle (f32-built grids floor at ~2e-5)
    assert float(jnp.abs(report.u - u_exact).max()) < 1e-9


def test_solver3_poly_problem_discretely_exact():
    program = mg.repeat(mg.v_cycle(9, n_min=5, steps=4, coarse_target=1e-10, coarsen=3), 10)
    cfg = SolverConfig(omega=6.0 / 7.0, collect_node_stats=False)
    report = Solver3D(p3.POLY_PROBLEM_3D, cfg).run(program)
    assert report.error_vs_analytic < 1e-6


def test_solver3_trigger_mode():
    program = mg.v_cycle(17, n_min=5, steps=-1, coarse_target=1e-8, coarsen=3)
    cfg = SolverConfig(omega=6.0 / 7.0, trigger=1e-4, collect_node_stats=True)
    report = Solver3D(p3.REFERENCE_PROBLEM_3D, cfg).run(program)
    descend = [nd for nd in report.nodes if nd.kind == "descend"]
    assert descend and all(nd.steps >= 1 for nd in descend)
    assert report.error_vs_analytic < 0.05


def test_solver3_gpu_metric_runs():
    program = mg.v_cycle(9, n_min=5, steps=-1, coarse_target=1e-8, coarsen=3)
    cfg = SolverConfig(omega=6.0 / 7.0, trigger=1e-3, compat_error="gpu",
                       collect_node_stats=False)
    report = Solver3D(p3.REFERENCE_PROBLEM_3D, cfg).run(program)
    assert np.isfinite(report.error_vs_analytic)


def test_solver3_rbgs_smoother_fw_restriction():
    program = mg.v_cycle(17, n_min=5, steps=2, coarse_target=1e-8, coarsen=3)
    cfg = SolverConfig(smoother="rbgs", restriction="full_weighting",
                      collect_node_stats=False)
    report = Solver3D(p3.REFERENCE_PROBLEM_3D, cfg).run(program)
    assert report.error_vs_analytic < 0.05


def test_solver3_dense_coarse_option():
    from multigrid_poisson.schedule import CoarseSolve, CycleProgram, Descend, Ascend
    program = CycleProgram(
        length=1.0, min_x=0.0, min_y=0.0, n_max=17,
        instructions=(Descend(9, 3), CoarseSolve(0.0, option=0), Ascend(3)))
    cfg = SolverConfig(omega=6.0 / 7.0, collect_node_stats=False)
    report = Solver3D(p3.REFERENCE_PROBLEM_3D, cfg).run(program)
    assert report.error_vs_analytic < 0.05


def test_cli_dim3(tmp_path, capsys):
    from multigrid_poisson.cli import main
    out = tmp_path / "sol3d.npz"
    rc = main(["1", "schedules/test.txt", "--dim", "3", "--quiet",
               "--omega", "0.857", "--output", str(out), "--platform", "cpu"])
    assert rc == 0
    captured = capsys.readouterr().out
    assert "Error = " in captured
    u = np.load(out)["u"]
    assert u.shape == (16, 16, 16)
