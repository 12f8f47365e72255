"""compiled3 under a z-plane sharding policy: the SAME CycleProgram walk,
multi-device. Every level array is constrained to the policy's sharding —
contiguous z-plane blocks while the level is large, replicated below the
threshold — and GSPMD partitions the plain-jnp ops. Results must match the
single-device compiled3 engine on the 8-device virtual CPU mesh: elementwise
stencils partition exactly, only reductions (error metrics, the GS coarse
solve's stopping test) reorder.

2-D analog: tests/test_compiled.py's sharded cases (parallel.mesh.
ShardingPolicy). Reference: the whole schedule walk,
MG_solver_CPU.cpp:148-260 — single device there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import multigrid_poisson as mg
from multigrid_poisson.compiled3 import compile_program3
from multigrid_poisson.models import poisson3d as p3
from multigrid_poisson.parallel.mesh import (ZShardingPolicy3, make_mesh_z,
                                             z_sharding)
from multigrid_poisson.solver import SolverConfig

NDEV = 8
# max|Δu|/max|u|: elementwise stencils partition exactly; reductions reorder,
# and the Gauss-Seidel coarse solve's stopping test reads one, so it may
# stop a sweep earlier or later on the mesh
TOL = 1e-5


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == NDEV
    return make_mesh_z(jax.devices())


@pytest.fixture(scope="module")
def policy(mesh):
    return ZShardingPolicy3(mesh, threshold_planes=4)


def _cfg(**kw):
    kw.setdefault("omega", 6.0 / 7.0)
    kw.setdefault("collect_node_stats", False)
    return SolverConfig(**kw)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _agree(mesh, policy, program, cfg, err_rel=1e-4):
    prob = p3.REFERENCE_PROBLEM_3D
    cc1 = compile_program3(program, prob, cfg)
    u0, f0 = cc1.init()
    want, werr = cc1(u0, f0)
    with mesh:
        ccp = compile_program3(program, prob, cfg, policy=policy)
        us, fs = ccp.init()
        got, gerr = ccp(us, fs)
    assert _rel(got, want) <= TOL
    assert abs(float(gerr) - float(werr)) <= err_rel * max(
        abs(float(werr)), 1e-12)
    return got


def test_policy_shards_large_levels_only(policy):
    assert policy.is_sharded(65) and policy.is_sharded(33)
    assert not policy.is_sharded(17)
    assert policy.spec(17) == jax.sharding.PartitionSpec()


def test_policy_vcycle_65(mesh, policy):
    _agree(mesh, policy,
           mg.v_cycle(65, n_min=5, steps=3, coarse_target=1e-8, coarsen=3),
           _cfg())


def test_policy_vcycle_129_two_sharded_levels(mesh, policy):
    """129, 65 and 33 run z-sharded; 17 down replicate."""
    _agree(mesh, policy,
           mg.v_cycle(129, n_min=5, steps=3, coarse_target=1e-8, coarsen=3),
           _cfg())


def test_policy_wcycle(mesh, policy):
    _agree(mesh, policy,
           mg.w_cycle(65, n_min=5, steps=2, coarse_target=1e-8, coarsen=3),
           _cfg())


def test_policy_fmg(mesh, policy):
    _agree(mesh, policy,
           mg.fmg(65, n_min=5, steps=3, coarse_target=1e-8, coarsen=3),
           _cfg())


def test_policy_trigger(mesh, policy):
    """Sharded trigger loop: one sweep plus a psum'd metric per iteration;
    the stop decisions must match the single-device engine."""
    _agree(mesh, policy,
           mg.v_cycle(65, n_min=5, steps=-1, coarse_target=1e-8, coarsen=3),
           _cfg(trigger=1e-3, max_trigger_sweeps=30))


def test_policy_gpu_metric(mesh, policy):
    _agree(mesh, policy,
           mg.v_cycle(65, n_min=5, steps=3, coarse_target=1e-8, coarsen=3),
           _cfg(compat_error="gpu"))


def test_policy_chained_converges(mesh, policy):
    """Chained policy cycles reach the discretization floor."""
    n = 65
    prob = p3.REFERENCE_PROBLEM_3D
    program = mg.repeat(
        mg.v_cycle(n, n_min=5, steps=3, coarse_target=1e-8, coarsen=3), 6)
    with mesh:
        ccp = compile_program3(program, prob, _cfg(), policy=policy)
        us, fs = ccp.init()
        got, _ = ccp(us, fs)
    err = float(jnp.mean(jnp.abs(got - prob.analytic_grid(n))))
    assert err < 2e-3          # C·h² at n=65


# ---- z-sharded smoothing vs one device ----------------------------------------
# The shapes the retired per-shard brick kernels were pinned at: plane counts
# that do not divide the mesh, multi-pass sweep counts, both error metrics.

def _on_mesh(mesh, fn, *arrays):
    """``fn`` jitted with its array arguments constrained to z-plane
    blocks (GSPMD accepts plane counts that do not divide the mesh)."""
    sh = z_sharding(mesh)

    def run(*a):
        return fn(*[jax.lax.with_sharding_constraint(x, sh) for x in a])

    with mesh:
        return jax.jit(run)(*arrays)


def _err_rel(compat):
    """Metric tolerance: the clean metric is a sum of residuals (fp32
    reassociation); the gpu metric sums |Δu| of the last sweep, a
    difference that amplifies u's last-bit differences ~|u|/|Δu|-fold."""
    return 2e-4 if compat == "gpu" else 5e-6


def _fields(n):
    prob = p3.REFERENCE_PROBLEM_3D
    f = (prob.source_grid(n) + prob.boundary_grid(n)).astype(jnp.float32)
    u = (prob.boundary_grid(n) + 0.01 * f).astype(jnp.float32)
    return u, f


@pytest.mark.parametrize("n,steps,compat", [
    (33, 3, "clean"),
    (33, 11, "clean"),
    (33, 5, "gpu"),
    (33, 4, "clean"),
    (65, 1, "clean"),
])
def test_sharded_smooth3_err(mesh, n, steps, compat):
    h = 1.0 / (n - 1)
    u, f = _fields(n)
    want, werr = p3.smooth3(u, f, h, steps=steps, omega=6.0 / 7.0,
                            compat=compat)
    got, gerr = _on_mesh(mesh, lambda u, f: p3.smooth3(
        u, f, h, steps=steps, omega=6.0 / 7.0, compat=compat), u, f)
    assert _rel(got, want) <= TOL
    assert float(gerr) == pytest.approx(float(werr), rel=_err_rel(compat))


def test_sharded_prolong_smooth3(mesh):
    """Ascend leg (trilinear prolongation + add + post-sweeps + metric) on
    z-sharded operands vs one device."""
    from multigrid_poisson.solver3 import _prolong_add3

    n, steps = 65, 3
    m = (n + 1) // 2
    h = 1.0 / (n - 1)
    u, f = _fields(n)
    ec = (0.1 * p3.REFERENCE_PROBLEM_3D.source_grid(m)).astype(jnp.float32)

    def leg(u, f, ec):
        v = _prolong_add3(ec, u, n)
        return p3.smooth3(v, f, h, steps=steps, omega=6.0 / 7.0)

    want, werr = leg(u, f, ec)
    got, gerr = _on_mesh(mesh, leg, u, f, ec)
    assert _rel(got, want) <= TOL
    assert float(gerr) == pytest.approx(float(werr), rel=5e-6)


@pytest.mark.parametrize("compat,trigger", [("clean", 1e-3), ("gpu", 1e-3),
                                            ("clean", 1e-4)])
def test_sharded_trigger3(mesh, compat, trigger):
    """The device-side trigger loop on z-sharded state stops where the
    single-device loop stops."""
    n = 33
    h = 1.0 / (n - 1)
    u, f = _fields(n)
    args = (h, trigger, 6.0 / 7.0, compat, "jacobi", 200)
    want, werr, wk = p3.trigger_smooth3(u, f, *args)
    got, gerr, gk = _on_mesh(
        mesh, lambda u, f: p3.trigger_smooth3(u, f, *args), u, f)
    assert int(gk) == int(wk)
    assert _rel(got, want) <= TOL
    assert float(gerr) == pytest.approx(float(werr), rel=_err_rel(compat))


@pytest.mark.parametrize("negate", [False, True])
def test_sharded_residual3(mesh, negate):
    n = 33
    h = 1.0 / (n - 1)
    u, f = _fields(n)
    sign = -1.0 if negate else 1.0

    def res(u, f):
        return sign * p3.residual3(u, f, h)

    want = res(u, f)
    got = _on_mesh(mesh, res, u, f)
    # the partitioned fusion may round the cancelling neighbor sum in
    # another order: fp32 noise of ~eps·|u|·8/h²
    atol = 8 * 1.2e-7 * float(jnp.abs(u).max()) / (h * h)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("restriction", ["sampling", "full_weighting"])
@pytest.mark.parametrize("steps", [2, 3])
def test_sharded_descend_leg3(mesh, restriction, steps):
    """Pre-smoothing + residual + restriction on z-plane blocks whose
    plane count (65 over 8 devices) does not divide the mesh."""
    from multigrid_poisson.solver3 import _restrict_residual3

    n, m = 65, 33
    h = 1.0 / (n - 1)
    u, f = _fields(n)

    def leg(u, f):
        v, _ = p3.smooth3(u, f, h, steps=steps, omega=6.0 / 7.0)
        return _restrict_residual3(v, f, h, m, restriction=restriction)

    want = leg(u, f)
    got = _on_mesh(mesh, leg, u, f)
    # the restricted residual carries the residual's fp32 cancellation
    # noise (≈ eps·|u|·8/h²) once per op that can round differently: each
    # sweep and the residual itself
    atol = (steps + 1) * 8 * 1.2e-7 * float(jnp.abs(u).max()) / (h * h)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("n", [65, 129])
def test_sharded_v_cycle3(mesh, n):
    """models.poisson3d.v_cycle3 (the refinement's inner cycle) on
    z-sharded operands vs one device."""
    h = 1.0 / (n - 1)
    prob = p3.REFERENCE_PROBLEM_3D
    f = (prob.source_grid(n) + prob.boundary_grid(n)).astype(jnp.float32)
    u = prob.boundary_grid(n).astype(jnp.float32)

    def cyc(u, f):
        return p3.v_cycle3(u, f, h, pre=2, post=2, coarse_sweeps=20)

    want = cyc(u, f)
    got = _on_mesh(mesh, cyc, u, f)
    assert _rel(got, want) <= TOL


def test_sharded_v_cycle3_unsharded_top(mesh):
    """A grid too small to shard under the policy still runs through it."""
    pol = ZShardingPolicy3(mesh)              # threshold 8 planes/device
    assert not pol.is_sharded(33)
    _agree(mesh, pol,
           mg.v_cycle(33, n_min=5, steps=2, coarse_option=0, coarsen=3),
           _cfg())


def test_refine3_under_z_sharding_converges(mesh):
    """The 3-D refinement loop with its state z-sharded reaches its
    tolerance in the same number of cycles as one device."""
    from multigrid_poisson.refine3 import IterativeRefinement3

    n = 33
    s = IterativeRefinement3(p3.REFERENCE_PROBLEM_3D, n, state="tw32",
                             max_cycles=30)
    f = s.init_rhs()
    u0, u1 = s.initial_state()
    args = (u0, u1, jnp.zeros_like(u0), f)
    want = s._run(*args, 1e-10, 30)
    got = _on_mesh(mesh, lambda a, b, c, d: s._run(a, b, c, d, 1e-10, 30),
                   *args)
    assert int(got[-1]) == int(want[-1])
    assert float(got[-2]) <= 1e-10
