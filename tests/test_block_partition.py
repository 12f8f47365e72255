"""2-D block partitioning tests on the 8-device CPU mesh (2×4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import multigrid_poisson as mg
from multigrid_poisson.compiled import compile_program
from multigrid_poisson.parallel import multihost
from multigrid_poisson.parallel.mesh import (
    BlockShardingPolicy, make_mesh_2d,
)

PROBLEM = mg.REFERENCE_PROBLEM


@pytest.fixture(scope="module")
def mesh2d():
    return make_mesh_2d((2, 4))


def test_block_policy_transitions(mesh2d):
    pol = BlockShardingPolicy(mesh2d, threshold_rows=32)
    assert pol.spec(257) == P("rows", "cols")    # 128 rows/dev, 64 cols/dev
    assert pol.spec(129) == P("rows", "cols")    # 64 rows/dev, 32 cols/dev
    assert pol.spec(100) == P("rows", None)      # cols/dev 25 < threshold
    assert pol.spec(33) == P()                   # replicated (agglomeration)


def test_compiled_block_sharded_matches_single(mesh2d):
    policy = BlockShardingPolicy(mesh2d, threshold_rows=8)
    program = mg.v_cycle(129, n_min=8, steps=3, coarse_target=1e-7)
    single = compile_program(program, PROBLEM, donate=False)
    u, f = single.init()
    u1, _ = single(u, f)
    blocked = compile_program(program, PROBLEM, policy=policy, donate=False)
    ub, fb = blocked.init()
    u2, _ = blocked(ub, fb)
    np.testing.assert_allclose(np.asarray(blocked.unpad(u2)),
                               np.asarray(single.unpad(u1)),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.slow
def test_refine_block_sharded(mesh2d):
    from multigrid_poisson.refine import solve_to_tolerance

    policy = BlockShardingPolicy(mesh2d, threshold_rows=8)
    rep = solve_to_tolerance(PROBLEM, 129, tol=1e-9, policy=policy)
    assert rep.rel_residual <= 1e-9


def test_hybrid_mesh_single_host():
    mesh = multihost.hybrid_block_mesh()
    assert mesh.shape == {"rows": 2, "cols": 4}
    mesh3 = multihost.hybrid_block_mesh(rows_parallelism=4)
    assert mesh3.shape == {"rows": 4, "cols": 2}
    pol = multihost.block_policy(mesh, threshold_rows=8)
    assert pol.is_sharded(64)


def test_hybrid_mesh_multihost_branch(monkeypatch):
    """Mock coverage of the n_hosts > 1 path (real multi-host hardware is
    unavailable here): 2 fake hosts x 4 local devices must produce a 2x4
    rows-by-cols mesh built through create_hybrid_device_mesh with hosts on
    the (inter-host) row axis."""
    import jax
    from jax.experimental import mesh_utils

    calls = {}

    def fake_hybrid(mesh_shape, dcn_mesh_shape, process_is_granule=False):
        calls["mesh_shape"] = tuple(mesh_shape)
        calls["dcn_mesh_shape"] = tuple(dcn_mesh_shape)
        calls["process_is_granule"] = process_is_granule
        return np.asarray(jax.devices()).reshape(2, 4)

    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "local_device_count", lambda: 4)
    monkeypatch.setattr(mesh_utils, "create_hybrid_device_mesh", fake_hybrid)
    mesh = multihost.hybrid_block_mesh()
    assert mesh.shape == {"rows": 2, "cols": 4}
    # virtual CPU devices expose no slice structure -> process granules
    # (the real 2-process run in test_multihost_proc.py takes this branch)
    assert calls == {"mesh_shape": (1, 4), "dcn_mesh_shape": (2, 1),
                     "process_is_granule": True}
    pol = multihost.block_policy(mesh, threshold_rows=8)
    assert pol.is_sharded(64)


def test_initialize_multihost_paths(monkeypatch):
    """initialize(): no-op when already distributed; otherwise forwards the
    explicit coordinator kwargs to jax.distributed.initialize."""
    import jax

    from jax._src import distributed as _dist

    calls = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: calls.append(kw))

    # the guard must ask the distributed runtime, NOT jax.process_count()
    # (which would initialize the backend and make a later real initialize
    # impossible — found by the real 2-process run)
    monkeypatch.setattr(_dist.global_state, "client", object(),
                        raising=False)
    multihost.initialize()                  # already initialized -> no-op
    assert calls == []

    monkeypatch.setattr(_dist.global_state, "client", None, raising=False)
    multihost.initialize("10.0.0.1:8476", num_processes=4, process_id=2)
    assert calls == [dict(coordinator_address="10.0.0.1:8476",
                          num_processes=4, process_id=2)]
    multihost.initialize()                  # auto-detect defaults
    assert calls[-1] == {}


def test_near_square_factor():
    assert multihost._near_square_factor(8) == 2
    assert multihost._near_square_factor(16) == 4
    assert multihost._near_square_factor(6) == 2
    assert multihost._near_square_factor(7) == 1


def test_fmg_block_sharded_matches_single():
    """BASELINE config 5's shape (VERDICT r2 item 6): an FMG schedule
    (steps=0 descents restrict the RHS itself) under the 2-D block policy on
    the hybrid-mesh layout (multihost.hybrid_block_mesh — hosts ride the
    row axis on real multi-host meshes), vs single device."""
    mesh = multihost.hybrid_block_mesh()          # 2x4 on the virtual mesh
    policy = multihost.block_policy(mesh, threshold_rows=8)
    program = mg.fmg(65, n_min=8, steps=2, coarse_target=1e-7, coarsen=3)
    cfg = mg.SolverConfig(omega=0.8, collect_node_stats=False)

    single = compile_program(program, PROBLEM, cfg, donate=False)
    u, f = single.init()
    u1, _ = single(u, f)
    blocked = compile_program(program, PROBLEM, cfg, policy=policy,
                              donate=False)
    ub, fb = blocked.init()
    u2, _ = blocked(ub, fb)
    np.testing.assert_allclose(np.asarray(blocked.unpad(u2)),
                               np.asarray(single.unpad(u1)),
                               rtol=1e-4, atol=1e-6)
    # FMG lands at the discretization floor in ONE pass
    spec = single.finest_spec
    ana = PROBLEM.analytic_grid(spec, jnp.float32)
    err = float(jnp.mean(jnp.abs(blocked.unpad(u2) - ana)))
    assert err < 5e-3
