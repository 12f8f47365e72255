"""End-to-end solver tests.

The parity values below were produced by compiling and running the reference
CPU binary (g++ -O2 -fopenmp MG_solver_CPU.cpp linkedlist.cpp) on the four
bundled schedules; it prints mean |U − analytic| as "Error" (MG_solver_CPU.cpp:441-450):

    test.txt          Error = 0.000666   (full precision 6.658e-4)
    Vcycle.txt        Error = 0.000876
    Wcycle.txt        Error = 0.000050
    VcycleTrigger.txt Error = 0.000784, trigger sweep counts
                      descend [2, 2, 2, 4, 14], ascend [2, 2, 2, 2, 2]
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

from multigrid_poisson import (
    REFERENCE_PROBLEM,
    SolverConfig,
    fmg,
    parse_cycle_path,
    repeat,
    solve,
    v_cycle,
    w_cycle,
)
from multigrid_poisson.models import sine_problem
from multigrid_poisson.ops import relative_residual_norm
from multigrid_poisson.solver import MultigridSolver

SCHEDULES = pathlib.Path(__file__).resolve().parent.parent / "schedules"
F64 = SolverConfig(dtype=jnp.float64)


def run_schedule(name, config=F64):
    program = parse_cycle_path(SCHEDULES / name)
    return solve(REFERENCE_PROBLEM, program, config)


def test_two_grid_parity_with_reference():
    rep = run_schedule("test.txt")
    assert rep.error_vs_analytic == pytest.approx(6.658e-4, rel=1e-2)
    kinds = [n.kind for n in rep.nodes]
    assert kinds == ["descend", "coarse-solve", "ascend"]


def test_vcycle_parity_with_reference():
    rep = run_schedule("Vcycle.txt")
    assert rep.error_vs_analytic == pytest.approx(8.756e-4, rel=1e-2)


def test_wcycle_parity_with_reference():
    rep = run_schedule("Wcycle.txt")
    assert rep.error_vs_analytic == pytest.approx(5.008e-5, rel=1e-2)


def test_trigger_parity_with_reference():
    rep = run_schedule("VcycleTrigger.txt")
    assert rep.error_vs_analytic == pytest.approx(7.839e-4, rel=1e-2)
    descend_steps = [n.steps for n in rep.nodes if n.kind == "descend"]
    ascend_steps = [n.steps for n in rep.nodes if n.kind == "ascend"]
    assert descend_steps == [2, 2, 2, 4, 14]
    assert ascend_steps == [2, 2, 2, 2, 2]


def test_repeated_vcycles_converge_deep():
    """Warm-restart chaining: 12 damped-Jacobi V-cycles reach ~1e-12 residual."""
    prog = repeat(v_cycle(65, 5, steps=3, coarse_target=1e-12), 12)
    cfg = SolverConfig(dtype=jnp.float64, omega=0.8, collect_node_stats=False)
    rep = MultigridSolver(REFERENCE_PROBLEM, cfg).run(prog)
    f = REFERENCE_PROBLEM.source_grid(rep.spec, jnp.float64)
    assert float(relative_residual_norm(rep.u, f, rep.spec.h)) < 1e-10
    # at the discretization-error floor
    assert rep.error_vs_analytic < 1e-5


def test_warm_restart_improves_over_single_cycle():
    cfg = SolverConfig(dtype=jnp.float64, omega=0.8, collect_node_stats=False)
    one = MultigridSolver(REFERENCE_PROBLEM, cfg).run(v_cycle(65, 5, steps=3))
    three = MultigridSolver(REFERENCE_PROBLEM, cfg).run(repeat(v_cycle(65, 5, steps=3), 3))
    f = REFERENCE_PROBLEM.source_grid(one.spec, jnp.float64)
    r1 = float(relative_residual_norm(one.u, f, one.spec.h))
    r3 = float(relative_residual_norm(three.u, f, three.spec.h))
    assert r3 < r1 / 10


def test_fmg_reaches_discretization_error_in_one_pass():
    """The FMG descent (the reference's TODO branch) + smoothed ascent should land
    near the discretization error without any extra V-cycles."""
    prog = fmg(65, 5, steps=3, coarse_target=1e-12)
    cfg = SolverConfig(dtype=jnp.float64, omega=0.8, collect_node_stats=False)
    rep = MultigridSolver(REFERENCE_PROBLEM, cfg).run(prog)
    assert rep.error_vs_analytic < 5e-5
    kinds = [n.kind for n in rep.nodes]
    assert kinds[:3] == ["fmg-descend"] * 3  # 65 -> 32 -> 16 -> 8
    assert kinds[3] == "coarse-solve"


def test_wcycle_generator_runs():
    rep = solve(REFERENCE_PROBLEM, w_cycle(33, 8, steps=3), F64)
    assert rep.error_vs_analytic < 1e-3


def test_float32_default_policy():
    rep = solve(REFERENCE_PROBLEM, v_cycle(33, 8, steps=3))
    assert rep.u.dtype == jnp.float32
    assert rep.error_vs_analytic < 5e-3


def test_sine_problem_converges():
    prob = sine_problem()
    prog = repeat(v_cycle(65, 5, steps=3, coarse_target=1e-12), 8)
    cfg = SolverConfig(dtype=jnp.float64, omega=0.8, collect_node_stats=False)
    rep = MultigridSolver(prob, cfg).run(prog)
    assert rep.error_vs_analytic < 5e-4


def test_solution_boundary_is_exact():
    rep = run_schedule("test.txt")
    u = np.asarray(rep.u)
    assert np.all(u[0, :] == 0) and np.all(u[-1, :] == 0)
    assert np.all(u[:, 0] == 0) and np.all(u[:, -1] == 0)


def test_report_summary_format():
    rep = run_schedule("test.txt")
    s = rep.summary()
    assert "===== Final Result =====" in s
    assert "Time Used" in s
