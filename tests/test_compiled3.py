"""compiled3 (whole-schedule XLA program) vs solver3 (interpreted) consistency.

The 3-D analog of tests/test_compiled.py: both engines execute the same
instruction semantics, so their outputs must agree to fp tolerance on every
schedule shape (V, W, repeat-chained, trigger, FMG, dense coarse)."""

import jax.numpy as jnp
import numpy as np
import pytest

import multigrid_poisson as mg
from multigrid_poisson.compiled3 import compile_program3
from multigrid_poisson.models import poisson3d as p3
from multigrid_poisson.solver import SolverConfig
from multigrid_poisson.solver3 import Solver3D


def _agree(program, cfg, problem=p3.REFERENCE_PROBLEM_3D, atol=1e-5):
    report = Solver3D(problem, cfg).run(program)
    cc = compile_program3(program, problem, cfg)
    u, f = cc.init()
    u1, err = cc(u, f)
    np.testing.assert_allclose(np.asarray(u1), np.asarray(report.u),
                               rtol=0, atol=atol)
    return report, u1, err


def test_vcycle_consistency():
    program = mg.v_cycle(17, n_min=5, steps=3, coarse_target=1e-8, coarsen=3)
    _agree(program, SolverConfig(omega=6.0 / 7.0, collect_node_stats=False))


def test_wcycle_consistency():
    program = mg.w_cycle(17, n_min=5, steps=2, coarse_target=1e-8, coarsen=3)
    _agree(program, SolverConfig(omega=6.0 / 7.0, collect_node_stats=False))


def test_repeat_warm_restart_consistency():
    program = mg.repeat(
        mg.v_cycle(9, n_min=5, steps=3, coarse_target=1e-9, coarsen=3), 4)
    _agree(program, SolverConfig(omega=6.0 / 7.0, collect_node_stats=False))


def test_trigger_consistency():
    program = mg.v_cycle(17, n_min=5, steps=-1, coarse_target=1e-8, coarsen=3)
    _agree(program, SolverConfig(omega=6.0 / 7.0, trigger=1e-4,
                                 collect_node_stats=False))


def test_fmg_consistency():
    program = mg.fmg(17, n_min=5, steps=3, coarse_target=1e-8, coarsen=3)
    _agree(program, SolverConfig(omega=6.0 / 7.0, collect_node_stats=False))


def test_dense_coarse_consistency():
    from multigrid_poisson.schedule import (Ascend, CoarseSolve,
                                                       CycleProgram, Descend)
    program = CycleProgram(
        length=1.0, min_x=0.0, min_y=0.0, n_max=17,
        instructions=(Descend(9, 3), CoarseSolve(0.0, option=0), Ascend(3)))
    _agree(program, SolverConfig(omega=6.0 / 7.0, collect_node_stats=False))


def test_warm_chaining_across_calls():
    """cc(u1, f, warm=True) continues converging (init-flag semantics)."""
    program = mg.v_cycle(9, n_min=5, steps=3, coarse_target=1e-9, coarsen=3)
    cfg = SolverConfig(omega=6.0 / 7.0, dtype=jnp.float64,
                       collect_node_stats=False)
    cc = compile_program3(program, p3.REFERENCE_PROBLEM_3D, cfg)
    u, f = cc.init()
    u1, _ = cc(u, f)
    u2, _ = cc(u1, f, warm=True)
    u3, _ = cc(u2, f, warm=True)
    fe = (p3.REFERENCE_PROBLEM_3D.source_grid(9, jnp.float64)
          + p3.REFERENCE_PROBLEM_3D.boundary_grid(9, jnp.float64))
    ue = p3.dense_solve3(fe, 1.0 / 8)
    d1 = float(jnp.abs(u1 - ue).max())
    d3 = float(jnp.abs(u3 - ue).max())
    assert d3 < d1 * 1e-2  # ~1/36 contraction per cycle, two extra cycles


# ---- engine consistency grid ------------------------------------------------
# The schedule/config points of the retired padded-brick engine's
# consistency tests, now on the one XLA engine: aligned n=65 levels,
# full-weighting restriction, fixed-step and trigger levels under both
# error metrics, FMG.


def _cfg(**kw):
    kw.setdefault("omega", 6.0 / 7.0)
    kw.setdefault("collect_node_stats", False)
    return SolverConfig(**kw)


@pytest.mark.parametrize("n,steps,cfg_kw", [
    pytest.param(17, 3, {}, id="v17"),
    pytest.param(65, 2, {}, id="v65-aligned"),
    pytest.param(65, 2, {"restriction": "full_weighting"}, id="v65-fw"),
    pytest.param(17, -1, {"trigger": 1e-4}, id="trigger17"),
    pytest.param(65, -1, {"trigger": 1e-4}, id="trigger65"),
    pytest.param(65, 2, {"compat_error": "gpu"}, id="v65-gpu"),
    pytest.param(65, -1, {"trigger": 1e-3, "compat_error": "gpu"},
                 id="trigger65-gpu"),
])
def test_engine_consistency_grid(n, steps, cfg_kw):
    program = mg.v_cycle(n, n_min=5, steps=steps, coarse_target=1e-8,
                         coarsen=3)
    _agree(program, _cfg(**cfg_kw))


def test_fmg17_consistency_dense_cfg():
    program = mg.fmg(17, n_min=5, steps=3, coarse_target=1e-8, coarsen=3)
    _agree(program, _cfg(compat_error="gpu"))
