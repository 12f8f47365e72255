"""Compiled engine vs interpreted engine across schedule shapes.

The schedule shapes the retired whole-V-cycle chain and whole-loop trigger
kernels were held to — V-shaped remainders with either restriction,
W-cycle inner excursions entered from zero, per-level step counts with
0-sweep ascends, W-shaped suffixes, the gpu metric at the finest level,
trigger loops under all three metrics and at larger sizes — now run through
the one compiled path (compiled.py, plain XLA). The interpreted engine
(solver.MultigridSolver on the ops.stencils oracle ops) is the reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import multigrid_poisson as mg
from multigrid_poisson.compiled import compile_program
from multigrid_poisson.schedule import Ascend, CoarseSolve, CycleProgram, Descend

PROBLEM = mg.REFERENCE_PROBLEM


def _agree(program, cfg, atol=1e-6, err_rel=1e-3):
    cc = compile_program(program, PROBLEM, cfg, donate=False)
    u, f = cc.init()
    u1, err = cc(u, f)
    rep = mg.MultigridSolver(PROBLEM, cfg).run(program)
    np.testing.assert_allclose(np.asarray(cc.unpad(u1)), np.asarray(rep.u),
                               rtol=0, atol=atol)
    finest = [nd for nd in rep.nodes if nd.n == program.n_max
              and nd.error is not None]
    if finest:
        assert float(err) == pytest.approx(finest[-1].error, rel=err_rel)
    return rep


def _program(n_max, instructions):
    return CycleProgram(length=1.0, min_x=0.0, min_y=0.0, n_max=n_max,
                        instructions=tuple(instructions))


def _cfg(**kw):
    kw.setdefault("omega", 0.8)
    return mg.SolverConfig(**kw)


@pytest.mark.parametrize("restriction", ["sampling", "full_weighting"])
@pytest.mark.parametrize("n", [65, 129])
def test_v_shaped_cycle(restriction, n):
    program = mg.v_cycle(n, n_min=5, steps=3, coarse_option=0, coarsen=3)
    _agree(program, _cfg(restriction=restriction))


@pytest.mark.parametrize("steps", [1, 2, 4])
def test_w_cycle_inner_excursions(steps):
    """W-cycles re-enter coarse levels whose correction restarts from
    zero (the closed-form first sweep)."""
    program = mg.w_cycle(33, n_min=5, steps=steps, coarse_option=0,
                         coarsen=3)
    _agree(program, _cfg(omega=1.0))


@pytest.mark.parametrize("pre,post", [((3, 1, 2), (0, 2, 1)),
                                      ((2, 2, 2), (0, 0, 0)),
                                      ((1, 3, 0), (3, 0, 2))])
def test_per_level_steps_and_zero_post(pre, post):
    """Per-level step counts, including 0-sweep (add-only) ascends."""
    sizes = (65, 33, 17, 9)
    ins = [Descend(sizes[k + 1], pre[k]) for k in range(3)]
    ins.append(CoarseSolve(0.0, option=0))
    ins += [Ascend(post[k]) for k in (2, 1, 0)]
    # a 0-sweep Descend is an FMG descent; keep smoothing descents >= 1
    if 0 in pre:
        ins[pre.index(0)] = Descend(sizes[pre.index(0) + 1], 1)
    _agree(_program(65, ins), _cfg())


def test_w_shaped_suffix():
    """Fewer ascends than descends before the next descent."""
    ins = [Descend(33, 2), Descend(17, 2), Descend(9, 2),
           CoarseSolve(0.0, option=0), Ascend(2), Descend(9, 2),
           CoarseSolve(0.0, option=0), Ascend(2), Ascend(2), Ascend(2)]
    _agree(_program(65, ins), _cfg())


@pytest.mark.parametrize("steps", [1, 3])
def test_gpu_metric_at_finest(steps):
    program = mg.v_cycle(65, n_min=5, steps=steps, coarse_option=0,
                         coarsen=3)
    _agree(program, _cfg(compat_error="gpu"))


@pytest.mark.parametrize("compat", [True, False, "gpu"])
@pytest.mark.parametrize("n", [65, 257])
def test_trigger_levels(compat, n):
    """Device-side trigger loops stop where the interpreted engine's do."""
    program = mg.v_cycle(n, n_min=8, steps=-1, coarse_option=0)
    rep = _agree(program, _cfg(compat_error=compat, trigger=1e-2),
                 atol=2e-6)
    assert any(nd.steps and nd.steps > 1 for nd in rep.nodes)


@pytest.mark.parametrize("compat", [True, False])
def test_chained_cycles_finest_error(compat):
    """Chained warm-restarted cycles report the finest level's metric of
    the last ascend. By the second cycle the residual is within ~10× of
    its fp32 cancellation noise (eps·|u|/h² per point), which the two
    engines' different op orders draw differently: the metrics agree to
    1e-2, the iterates to 2e-6."""
    program = mg.repeat(
        mg.v_cycle(129, n_min=5, steps=3, coarse_option=0, coarsen=3), 2)
    _agree(program, _cfg(compat_error=compat), atol=2e-6, err_rel=1e-2)


def test_chain_converges_to_discretization_floor():
    program = mg.repeat(
        mg.v_cycle(65, n_min=5, steps=3, coarse_option=0, coarsen=3), 8)
    cc = compile_program(program, PROBLEM, _cfg(), donate=False)
    u, f = cc.init()
    u1, _ = cc(u, f)
    ua = PROBLEM.analytic_grid(cc.finest_spec, jnp.float32)
    err = float(jnp.mean(jnp.abs(cc.unpad(u1) - ua)))
    floor = mg.solve_to_tolerance(PROBLEM, 65, tol=1e-12,
                                  state="tw32").error_vs_analytic
    assert err <= 1.05 * floor
