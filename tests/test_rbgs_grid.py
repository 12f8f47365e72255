"""Red-black Gauss-Seidel smoothing on the compiled engine's XLA path.

The reference runs GS on its accelerator as paired color kernels
(ker_GaussSeideleven/odd_GPU, MG_solver_GPU.cu:663-795). Here the engine's
smoother="rbgs" is two masked half-updates per sweep in ops.padded, left to
XLA. These tests pin it against the unpadded oracle (ops.stencils) at the
sizes, sweep counts and metrics the retired fused kernel was held to; under
the rows and 2-D block sharding policies against one device; and the engine
against the interpreted engine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding

import multigrid_poisson as mg
from multigrid_poisson import compiled as C
from multigrid_poisson.compiled import compile_program
from multigrid_poisson.ops import layout, stencils
from multigrid_poisson.parallel.mesh import (
    BlockShardingPolicy,
    ShardingPolicy,
    make_mesh,
    make_mesh_2d,
)

PROBLEM = mg.REFERENCE_PROBLEM
RBGS = mg.SolverConfig(smoother="rbgs", restriction="full_weighting",
                       collect_node_stats=False)


def _fields(n, seed=3):
    rng = np.random.default_rng(seed)
    u = jnp.asarray(rng.standard_normal((n, n)), jnp.float32)
    f = jnp.asarray(rng.standard_normal((n, n)), jnp.float32)
    return u, f


def _oracle(u, f, h, steps):
    for _ in range(steps):
        u = stencils.redblack_gs_sweep(u, f, h)
    return u


@pytest.mark.parametrize("n,steps", [(33, 1), (129, 4), (129, 7), (137, 5)])
def test_rbgs_sweeps_match_oracle(n, steps):
    u, f = _fields(n)
    h = 1.0 / (n - 1)
    got = C._sweeps(layout.pad_grid(u), layout.pad_grid(f), h, n, steps,
                    RBGS)
    np.testing.assert_allclose(np.asarray(layout.unpad_grid(got, n)),
                               np.asarray(_oracle(u, f, h, steps)),
                               rtol=0, atol=1e-6)


def test_rbgs_from_zero_matches_oracle():
    n, steps = 129, 3
    _, f = _fields(n)
    h = 1.0 / (n - 1)
    fp = layout.pad_grid(f)
    got = C._sweeps(jnp.zeros_like(fp), fp, h, n, steps, RBGS,
                    from_zero=True)
    np.testing.assert_allclose(
        np.asarray(layout.unpad_grid(got, n)),
        np.asarray(_oracle(jnp.zeros_like(f), f, h, steps)),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("steps", [1, 3, 5])
def test_rbgs_error_matches_oracle(compat, steps):
    n = 129
    u, f = _fields(n)
    h = 1.0 / (n - 1)
    cfg = mg.SolverConfig(smoother="rbgs", compat_error=compat)
    got, err = C._smooth_traced(layout.pad_grid(u), layout.pad_grid(f), h, n,
                                steps, cfg, want_err=True)
    want, werr = stencils.smooth(u, f, h, steps=steps, compat=compat,
                                 smoother="rbgs")
    np.testing.assert_allclose(np.asarray(layout.unpad_grid(got, n)),
                               np.asarray(want), rtol=0, atol=1e-6)
    assert abs(float(err) - float(werr)) <= 1e-5 * abs(float(werr))


def _policies():
    return [
        pytest.param(lambda: ShardingPolicy(make_mesh(), threshold_rows=8),
                     id="rows-1d"),
        pytest.param(lambda: BlockShardingPolicy(make_mesh_2d((2, 4)),
                                                 threshold_rows=8),
                     id="block-2d"),
    ]


def _sharded_smooth(policy, n, steps, want_err):
    """The engine's smoothing on operands constrained to the policy's
    sharding of level n (GSPMD inserts the halo exchange), and the same
    call on one device."""
    rng = np.random.default_rng(11)
    rp, cp = policy.padded_shape(n)
    u = jnp.zeros((rp, cp), jnp.float32).at[:n, :n].set(
        jnp.asarray(rng.random((n, n)), jnp.float32))
    f = jnp.zeros((rp, cp), jnp.float32).at[:n, :n].set(
        jnp.asarray(rng.random((n, n)), jnp.float32))
    h = 1.0 / (n - 1)
    cfg = mg.SolverConfig(smoother="rbgs")

    def run(u, f):
        return C._smooth_traced(u, f, h, n, steps, cfg, want_err=want_err)

    sh = NamedSharding(policy.mesh, policy.spec(n))
    got = jax.jit(run)(jax.device_put(u, sh), jax.device_put(f, sh))
    want = jax.jit(run)(u, f)
    return got, want


@pytest.mark.parametrize("make_policy", _policies())
@pytest.mark.parametrize("steps", [1, 4, 6])
def test_sharded_rbgs_matches_unsharded(make_policy, steps):
    (got, _), (want, _) = _sharded_smooth(make_policy(), 129, steps, False)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("make_policy", _policies())
def test_sharded_rbgs_err_matches_unsharded(make_policy):
    (got, err), (want, werr) = _sharded_smooth(make_policy(), 129, 3, True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert abs(float(err) - float(werr)) <= 1e-6 * abs(float(werr))


def test_compiled_rbgs_matches_interpreted():
    program = mg.v_cycle(65, n_min=8, steps=2, coarse_option=0, coarsen=3)
    cc = compile_program(program, PROBLEM, RBGS, donate=False)
    u, f = cc.init()
    u, _ = cc(u, f)
    rep = mg.solve(PROBLEM, program, RBGS)
    np.testing.assert_allclose(np.asarray(cc.unpad(u)), np.asarray(rep.u),
                               rtol=0, atol=1e-6)


def test_compiled_rbgs_trigger_schedule():
    """Trigger (step=-1) levels under rbgs: the cycle converges and matches
    the interpreted rbgs trigger engine."""
    program = mg.v_cycle(65, n_min=8, steps=-1, coarse_option=0, coarsen=3)
    cc = compile_program(program, PROBLEM, RBGS, donate=False)
    u, f = cc.init()
    u, _ = cc(u, f)
    ua = PROBLEM.analytic_grid(cc.finest_spec, jnp.float32)
    err = float(stencils.mean_abs_error(cc.unpad(u), ua))
    rep = mg.solve(PROBLEM, program, RBGS)
    assert err < 0.05
    assert abs(err - rep.error_vs_analytic) <= 1e-5 * rep.error_vs_analytic


def test_rbgs_contracts_faster_than_jacobi_per_sweep():
    """rb-GS(2,2) reaches a lower algebraic residual than ω=0.8 Jacobi(2,2)
    with the same cycle shape."""
    n = 65
    program = mg.repeat(
        mg.v_cycle(n, n_min=8, steps=2, coarse_option=0, coarsen=3), 4)
    res = {}
    for smoother, omega in (("rbgs", 1.0), ("jacobi", 0.8)):
        cfg = mg.SolverConfig(smoother=smoother, omega=omega,
                              restriction="full_weighting",
                              collect_node_stats=False)
        cc = compile_program(program, PROBLEM, cfg, donate=False)
        u, f = cc.init()
        u, _ = cc(u, f)
        res[smoother] = float(stencils.relative_residual_norm(
            cc.unpad(u), cc.unpad(f), 1.0 / (n - 1)))
    assert res["rbgs"] < res["jacobi"]
