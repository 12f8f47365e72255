"""Multi-device tests: shard_map halo ops vs the single-device oracle.

Runs on the virtual 8-device CPU mesh (conftest.py). The oracle ops in
ops.stencils play the role the reference's CPU implementations play for its
CUDA kernels (testFunction/ harnesses, SURVEY.md §4) — every sharded op must
reproduce them on the global array for sizes that do and do not divide the
device count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multigrid_poisson.ops import stencils
from multigrid_poisson.parallel import halo
from multigrid_poisson.parallel.mesh import (
    ShardingPolicy, make_mesh, pad_rows, row_sharding, unpad_rows,
)

NDEV = 8


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == NDEV, "tests expect the 8-device CPU mesh"
    return make_mesh()


def _place(mesh, *arrays):
    sh = row_sharding(mesh)
    return tuple(jax.device_put(pad_rows(a, NDEV), sh) for a in arrays)


def _random_uf(rng, n, dtype=jnp.float32):
    u = jnp.asarray(rng.standard_normal((n, n)), dtype)
    f = jnp.asarray(rng.standard_normal((n, n)), dtype)
    return u, f


@pytest.mark.parametrize("n", [64, 67, 257])
def test_sharded_jacobi_matches_oracle(mesh, rng, n):
    u, f = _random_uf(rng, n)
    h = 1.0 / (n - 1)
    up, fp = _place(mesh, u, f)
    got = unpad_rows(halo.sharded_smooth(up, fp, h, 4, mesh), n)
    want, _ = stencils.smooth(u, f, h, steps=4)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=1e-6)
    # padding rows must stay exactly zero (they started zero)
    padded = halo.sharded_smooth(up, fp, h, 4, mesh)
    assert float(jnp.abs(padded[n:]).max(initial=0.0)) == 0.0


@pytest.mark.parametrize("n", [64, 67])
def test_sharded_rbgs_matches_oracle(mesh, rng, n):
    u, f = _random_uf(rng, n)
    h = 1.0 / (n - 1)
    up, fp = _place(mesh, u, f)
    got = unpad_rows(halo.sharded_smooth(up, fp, h, 3, mesh, smoother="rbgs"), n)
    want = u
    for _ in range(3):
        want = stencils.redblack_gs_sweep(want, f, h)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [64, 67])
def test_sharded_residual_matches_oracle(mesh, rng, n):
    u, f = _random_uf(rng, n)
    h = 1.0 / (n - 1)
    up, fp = _place(mesh, u, f)
    got = unpad_rows(halo.sharded_residual(up, fp, h, mesh), n)
    want = stencils.residual(u, f, h)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-3 * float(jnp.abs(want).max()))


@pytest.mark.parametrize("compat", [True, False])
def test_sharded_smoothing_error_matches_oracle(mesh, rng, compat):
    n = 67
    u, f = _random_uf(rng, n)
    h = 1.0 / (n - 1)
    up, fp = _place(mesh, u, f)
    got = float(halo.sharded_smoothing_error(up, fp, h, mesh, compat=compat))
    want = float(stencils.smoothing_error(u, f, h, compat=compat))
    assert got == pytest.approx(want, rel=1e-4)


def test_boundary_rows_frozen_under_sharding(mesh, rng):
    """Dirichlet rows/cols (global index 0 and n−1) must never change."""
    n = 64
    u, f = _random_uf(rng, n)
    h = 1.0 / (n - 1)
    up, fp = _place(mesh, u, f)
    out = unpad_rows(halo.sharded_smooth(up, fp, h, 5, mesh), n)
    for sl in (np.s_[0, :], np.s_[-1, :], np.s_[:, 0], np.s_[:, -1]):
        np.testing.assert_array_equal(np.asarray(out[sl]), np.asarray(u[sl]))


def test_sharding_policy_thresholds(mesh):
    pol = ShardingPolicy(mesh, threshold_rows=32)
    assert pol.n_devices == NDEV
    assert pol.is_sharded(257)          # 32 rows/device
    assert not pol.is_sharded(255)      # 31 rows/device
    assert not pol.is_sharded(17)
    assert pol.spec(257) != pol.spec(17)
