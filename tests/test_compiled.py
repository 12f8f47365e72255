"""Whole-cycle compilation tests: compiled.CompiledCycle vs the interpreted engine.

The interpreted MultigridSolver is the semantic oracle (it is itself tested
against the reference's behavior in test_solver.py); the compiled path must
reproduce it for every schedule family, single-device and sharded.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import multigrid_poisson as mg
from multigrid_poisson.compiled import compile_program
from multigrid_poisson.ops import stencils
from multigrid_poisson.parallel.mesh import ShardingPolicy, make_mesh

PROBLEM = mg.REFERENCE_PROBLEM


def _final_error(u, spec, dtype=jnp.float32):
    ua = PROBLEM.analytic_grid(spec, dtype)
    return float(stencils.mean_abs_error(u, ua))


def _run_compiled(program, **kw):
    cc = compile_program(program, PROBLEM, donate=False, **kw)
    u, f = cc.init()
    u1, err = cc(u, f)
    return cc, cc.unpad(u1), err


@pytest.mark.parametrize("maker", [
    lambda: mg.v_cycle(65, n_min=8, steps=3, coarse_target=1e-7),
    lambda: mg.w_cycle(65, n_min=8, steps=2, coarse_target=1e-8),
    lambda: mg.fmg(65, n_min=8, steps=2, coarse_target=1e-8),
])
def test_compiled_matches_interpreted(maker):
    program = maker()
    rep = mg.solve(PROBLEM, program)
    cc, u1, _ = _run_compiled(program)
    # abs=3e-7: the engines run legitimately different fp32 op orders
    # (padded rolls + while_loops vs unpadded slices), so once the solution
    # is at the discretization floor (~6e-6 for the FMG case) their
    # mean-abs-error metrics differ by a few percent of the floor
    assert _final_error(u1, cc.finest_spec) == pytest.approx(
        rep.error_vs_analytic, rel=1e-3, abs=3e-7)
    np.testing.assert_allclose(np.asarray(u1), np.asarray(rep.u),
                               rtol=1e-4, atol=1e-6)


def test_compiled_trigger_schedule():
    program = mg.v_cycle(65, n_min=8, steps=-1, coarse_target=1e-7)
    rep = mg.solve(PROBLEM, program)
    cc, u1, _ = _run_compiled(program)
    np.testing.assert_allclose(np.asarray(u1), np.asarray(rep.u),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("steps", [-1, 3])
def test_compiled_gpu_metric_matches_interpreted(steps):
    """Both engines under compat_error='gpu' (the GPU reference's |ΔU|·4/h²
    per-sweep metric, MG_solver_GPU.cu:633): same solution, same final error
    scalar — trigger schedules replayed under GPU semantics take the same
    path in either engine."""
    cfg = mg.SolverConfig(compat_error="gpu")
    program = mg.v_cycle(65, n_min=8, steps=steps, coarse_target=1e-7)
    rep = mg.solve(PROBLEM, program, cfg)
    cc, u1, err = _run_compiled(program, config=cfg)
    np.testing.assert_allclose(np.asarray(u1), np.asarray(rep.u),
                               rtol=1e-4, atol=1e-6)
    finest = [n for n in rep.nodes if n.kind == "ascend" and n.n == 65]
    assert float(err) == pytest.approx(finest[-1].error, rel=1e-3)


def test_gpu_metric_trigger_takes_different_sweeps_than_cpu():
    """The GPU metric is a genuinely different quantity from the CPU
    color-bugged one, so the same trigger schedule lands on different sweep
    counts (SURVEY §5's three coexisting metrics)."""
    program = mg.v_cycle(65, n_min=8, steps=-1, coarse_target=1e-7)
    sweeps = {}
    for name, compat in [("cpu", True), ("gpu", "gpu")]:
        rep = mg.solve(PROBLEM, program, mg.SolverConfig(compat_error=compat))
        sweeps[name] = [n.steps for n in rep.nodes if n.kind == "descend"]
    assert sweeps["cpu"] != sweeps["gpu"]


def test_compiled_warm_restart_converges():
    program = mg.v_cycle(65, n_min=8, steps=3, coarse_target=1e-8)
    cold = compile_program(program, PROBLEM, warm=False, donate=False)
    warm = compile_program(program, PROBLEM, warm=True, donate=False)
    u, f = cold.init()
    u, _ = cold(u, f)
    e1 = _final_error(cold.unpad(u), cold.finest_spec)
    for _ in range(4):
        u, _ = warm(u, f)
    e5 = _final_error(cold.unpad(u), cold.finest_spec)
    assert e5 < e1 / 10  # multiple cycles keep converging (warm restart works)

    # warm restart must match the interpreted repeat() semantics (abs
    # tolerance: both runs sit at the fp32 floor after 5 cycles)
    rep = mg.solve(PROBLEM, mg.repeat(program, 5))
    assert e5 == pytest.approx(rep.error_vs_analytic, rel=5e-2, abs=1e-7)


def test_compiled_dense_coarse_option():
    program = mg.v_cycle(33, n_min=8, steps=3, coarse_option=0)
    rep = mg.solve(PROBLEM, program)
    cc, u1, _ = _run_compiled(program)
    np.testing.assert_allclose(np.asarray(u1), np.asarray(rep.u),
                               rtol=1e-4, atol=1e-6)


def test_compiled_last_err_is_finest_smoothing_error():
    program = mg.v_cycle(65, n_min=8, steps=3)
    cc, u1, err = _run_compiled(program)
    assert float(err) > 0
    # the last ascend's post-smoothing error at the finest level
    rep = mg.solve(PROBLEM, program)
    finest_reports = [n for n in rep.nodes if n.kind == "ascend" and n.n == 65]
    assert float(err) == pytest.approx(finest_reports[-1].error, rel=1e-3)


def test_compiled_sharded_matches_single_device():
    mesh = make_mesh()
    policy = ShardingPolicy(mesh, threshold_rows=8)
    program = mg.v_cycle(129, n_min=8, steps=3, coarse_target=1e-7)
    _, u_single, _ = _run_compiled(program)
    _, u_sharded, _ = _run_compiled(program, policy=policy)
    np.testing.assert_allclose(np.asarray(u_sharded), np.asarray(u_single),
                               rtol=1e-4, atol=1e-6)


def test_compiled_sharded_trigger_matches_single_device():
    mesh = make_mesh()
    policy = ShardingPolicy(mesh, threshold_rows=8)
    program = mg.v_cycle(65, n_min=8, steps=-1)
    _, u_single, _ = _run_compiled(program)
    _, u_sharded, _ = _run_compiled(program, policy=policy)
    np.testing.assert_allclose(np.asarray(u_sharded), np.asarray(u_single),
                               rtol=1e-4, atol=1e-6)

