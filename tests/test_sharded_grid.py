"""Sharded execution vs one device, on the 8-device virtual CPU mesh.

Two multi-device paths remain: GSPMD (the compiled engine's ops run on
operands constrained to a policy's sharding — rows-1d or block-2d — and XLA
inserts the halo collectives) and the explicit ``shard_map`` halo exchange
of parallel.halo. These tests hold both to the single-device result at the
shapes the retired per-shard and remote-DMA kernels were pinned at: sweep
counts 1-11, correction levels entered from zero, all three error metrics,
both restrictions, aligned and trigger schedules.
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
from multigrid_poisson.ops import padded as P
from multigrid_poisson.parallel import halo
from multigrid_poisson.parallel.mesh import (
    BlockShardingPolicy,
    ShardingPolicy,
    make_mesh,
    make_mesh_2d,
    pad_rows,
    row_sharding,
    unpad_rows,
)

PROBLEM = mg.REFERENCE_PROBLEM
NDEV = 8


def _policies():
    return [
        pytest.param(lambda: ShardingPolicy(make_mesh(), threshold_rows=8),
                     id="rows-1d"),
        pytest.param(lambda: BlockShardingPolicy(make_mesh_2d((2, 4)),
                                                 threshold_rows=8),
                     id="block-2d"),
    ]


def _padded_fields(policy, n, seed=5):
    rng = np.random.default_rng(seed)
    shape = policy.padded_shape(n)
    u = layout.pad_grid_to(jnp.asarray(rng.random((n, n)), jnp.float32),
                           shape)
    f = layout.pad_grid_to(jnp.asarray(rng.random((n, n)), jnp.float32),
                           shape)
    return u, f


def _both(policy, n, fn, *arrays):
    """``fn`` jitted on operands placed with the policy's sharding of level
    n, and on one device."""
    sh = NamedSharding(policy.mesh, policy.spec(n))
    got = jax.jit(fn)(*[jax.device_put(a, sh) for a in arrays])
    want = jax.jit(fn)(*arrays)
    return got, want


@pytest.mark.parametrize("make_policy", _policies())
@pytest.mark.parametrize("steps", [1, 8, 11])
def test_sharded_sweeps_match_unsharded(make_policy, steps):
    policy = make_policy()
    n, h = 129, 1.0 / 128
    u, f = _padded_fields(policy, n)
    cfg = mg.SolverConfig(omega=0.8)
    got, want = _both(policy, n, lambda u, f: C._sweeps(u, f, h, n, steps,
                                                        cfg), u, f)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("make_policy", _policies())
def test_sharded_sweeps_from_zero(make_policy):
    policy = make_policy()
    n, h = 129, 1.0 / 128
    _, f = _padded_fields(policy, n)
    cfg = mg.SolverConfig(omega=0.8)
    got, want = _both(policy, n, lambda u, f: C._sweeps(
        u, f, h, n, 3, cfg, from_zero=True), jnp.zeros_like(f), f)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("make_policy", _policies())
def test_sharded_residual_matches_unsharded(make_policy):
    policy = make_policy()
    n, h = 129, 1.0 / 128
    u, f = _padded_fields(policy, n)
    got, want = _both(policy, n, lambda u, f: P.residual_p(u, f, h, n), u, f)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("make_policy", _policies())
@pytest.mark.parametrize("compat", [True, False, "gpu"])
def test_sharded_smoothing_error(make_policy, compat):
    """The error metrics reduce across shards; the iterate is exact."""
    policy = make_policy()
    n, h = 129, 1.0 / 128
    u, f = _padded_fields(policy, n)
    cfg = mg.SolverConfig(omega=0.8, compat_error=compat)
    (gu, ge), (wu, we) = _both(policy, n, lambda u, f: C._smooth_traced(
        u, f, h, n, 3, cfg, want_err=True), u, f)
    np.testing.assert_array_equal(np.asarray(gu), np.asarray(wu))
    assert float(ge) == pytest.approx(float(we), rel=1e-5)


@pytest.mark.parametrize("make_policy", _policies())
@pytest.mark.parametrize("restriction", ["sampling", "full_weighting"])
@pytest.mark.parametrize("from_zero", [False, True])
def test_sharded_descend_leg(make_policy, restriction, from_zero):
    policy = make_policy()
    n, m, h = 129, 65, 1.0 / 128
    u, f = _padded_fields(policy, n)
    if from_zero:
        u = jnp.zeros_like(u)
    cfg = mg.SolverConfig(omega=0.8, restriction=restriction)

    def leg(u, f):
        u, err = C._smooth_traced(u, f, h, n, 3, cfg, want_err=True,
                                  from_zero=from_zero)
        return u, C._restrict(P.residual_p(u, f, h, n), n, m, cfg, policy)

    (gu, gc), (wu, wc) = _both(policy, n, leg, u, f)
    np.testing.assert_array_equal(np.asarray(gu), np.asarray(wu))
    np.testing.assert_allclose(np.asarray(gc), np.asarray(wc), rtol=0,
                               atol=1e-6 * float(jnp.abs(wc).max()))


@pytest.mark.parametrize("make_policy", _policies())
def test_sharded_ascend_leg(make_policy):
    policy = make_policy()
    n, m, h = 129, 65, 1.0 / 128
    u, f = _padded_fields(policy, n)
    rng = np.random.default_rng(9)
    uc = layout.pad_grid_to(jnp.asarray(rng.random((m, m)), jnp.float32)
                            .at[0].set(0).at[-1].set(0)
                            .at[:, 0].set(0).at[:, -1].set(0),
                            policy.padded_shape(m))
    cfg = mg.SolverConfig(omega=0.8)

    def leg(u, f, uc):
        corr = P.zoom_take_p(uc, m, n, u.shape)
        return C._sweeps(P.add_correction_p(u, corr, n), f, h, n, 3, cfg)

    got, want = _both(policy, n, leg, u, f, uc)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=1e-7)


def _engine_pair(program, policy, cfg):
    cc1 = compile_program(program, PROBLEM, cfg, donate=False)
    u, f = cc1.init()
    want = cc1.unpad(cc1(u, f)[0])
    ccp = compile_program(program, PROBLEM, cfg, policy=policy, donate=False)
    us, fs = ccp.init()
    got = ccp.unpad(ccp(us, fs)[0])
    return np.asarray(got), np.asarray(want)


@pytest.mark.parametrize("make_policy", _policies())
@pytest.mark.parametrize("steps", [3, -1])
def test_compiled_sharded_matches_single(make_policy, steps):
    program = mg.v_cycle(129, n_min=8, steps=steps, coarse_option=0)
    got, want = _engine_pair(program, make_policy(),
                             mg.SolverConfig(omega=0.8,
                                             collect_node_stats=False))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("make_policy", _policies())
def test_compiled_sharded_aligned_matches_single(make_policy):
    """A 2:1-aligned (coarsen=3) schedule with full weighting under both
    policies."""
    program = mg.v_cycle(129, n_min=8, steps=3, coarse_option=0, coarsen=3)
    got, want = _engine_pair(
        program, make_policy(),
        mg.SolverConfig(omega=0.8, restriction="full_weighting",
                        collect_node_stats=False))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("make_policy", _policies())
def test_sharded_trigger_loop_stops_like_unsharded(make_policy):
    """The trigger loop's stop test reads a cross-shard reduction; the
    sharded loop must take the same number of sweeps (same iterate)."""
    policy = make_policy()
    n, h = 129, 1.0 / 128
    u, f = _padded_fields(policy, n)
    cfg = mg.SolverConfig(omega=0.8, compat_error=True, trigger=1e-2,
                          max_trigger_sweeps=200)
    (gu, ge), (wu, we) = _both(policy, n, lambda u, f: C._trigger_smooth_traced(
        u, f, h, n, cfg), u, f)
    np.testing.assert_array_equal(np.asarray(gu), np.asarray(wu))
    assert float(ge) == pytest.approx(float(we), rel=1e-5)


def test_sharded_refinement_converges_deep():
    """Refinement with a sharded inner cycle reaches 1e-9."""
    policy = ShardingPolicy(make_mesh(), threshold_rows=8)
    rep = mg.solve_to_tolerance(PROBLEM, 129, tol=1e-9, policy=policy)
    assert rep.rel_residual <= 1e-9


# ---- parallel.halo (explicit shard_map + ppermute) ----------------------------

@pytest.fixture(scope="module")
def mesh():
    return make_mesh()


def _place(mesh, *arrays):
    sh = row_sharding(mesh)
    return tuple(jax.device_put(pad_rows(a, NDEV), sh) for a in arrays)


@pytest.mark.parametrize("steps", [1, 8, 11])
def test_halo_smoother_matches_oracle(mesh, steps):
    n = 129
    rng = np.random.default_rng(21)
    u = jnp.asarray(rng.standard_normal((n, n)), jnp.float32)
    f = jnp.asarray(rng.standard_normal((n, n)), jnp.float32)
    h = 1.0 / (n - 1)
    got = unpad_rows(halo.sharded_smooth(*_place(mesh, u, f), h, steps,
                                         mesh, omega=0.8), n)
    want, _ = stencils.smooth(u, f, h, steps=steps, omega=0.8)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("steps", [3, 8])
def test_halo_smoother_matches_gspmd(mesh, steps):
    """The explicit-halo path and the GSPMD engine ops agree."""
    n = 129
    h = 1.0 / (n - 1)
    policy = ShardingPolicy(mesh, threshold_rows=8)
    up, fp = _padded_fields(policy, n)
    u, f = layout.unpad_grid(up, n), layout.unpad_grid(fp, n)
    got = unpad_rows(halo.sharded_smooth(*_place(mesh, u, f), h, steps,
                                         mesh), n)
    gspmd, _ = _both(policy, n, lambda u, f: C._sweeps(
        u, f, h, n, steps, mg.SolverConfig()), up, fp)
    np.testing.assert_allclose(np.asarray(got),
                               np.asarray(layout.unpad_grid(gspmd, n)),
                               rtol=0, atol=1e-6)


def test_halo_smoother_four_devices_large_blocks():
    """Bigger per-device blocks on a 4-device sub-mesh."""
    mesh4 = make_mesh(jax.devices()[:4])
    n = 385
    rng = np.random.default_rng(23)
    u = jnp.asarray(rng.standard_normal((n, n)), jnp.float32)
    f = jnp.asarray(rng.standard_normal((n, n)), jnp.float32)
    h = 1.0 / (n - 1)
    sh = row_sharding(mesh4)
    up = jax.device_put(pad_rows(u, 4), sh)
    fp = jax.device_put(pad_rows(f, 4), sh)
    got = unpad_rows(halo.sharded_smooth(up, fp, h, 5, mesh4), n)
    want, _ = stencils.smooth(u, f, h, steps=5)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("compat", [True, False])
def test_halo_smoothing_error_matches_oracle(mesh, compat):
    n = 129
    rng = np.random.default_rng(25)
    u = jnp.asarray(rng.standard_normal((n, n)), jnp.float32)
    f = jnp.asarray(rng.standard_normal((n, n)), jnp.float32)
    h = 1.0 / (n - 1)
    got = halo.sharded_smoothing_error(*_place(mesh, u, f), h, mesh,
                                       compat=compat)
    want = stencils.smoothing_error(u, f, h, compat=compat)
    assert float(got) == pytest.approx(float(want), rel=1e-5)
