"""3-D under GSPMD: the plain-jnp 3-D V-cycle partitioned over the device
mesh must bit-match the single-device run.

The 3-D hot path is roll/slice stencils and separable transfers — all ops
GSPMD partitions natively (XLA inserts the halo collective-permutes), so the
multi-chip 3-D story needs no bespoke shard_map code: constrain the finest
level's sharding and let the compiler propagate. This test pins that down on
the virtual 8-device CPU mesh (z-axis 1-D decomposition: contiguous planes
per device, the natural 3-D analog of the 2-D rows policy). Odd grid sizes
(33, 65) are deliberately not divisible by 8 — GSPMD's internal padding must
handle the ragged last shard."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from multigrid_poisson.models import poisson3d as p3

NDEV = 8


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == NDEV
    return Mesh(np.asarray(jax.devices()).reshape(NDEV), ("z",))


@pytest.mark.parametrize("n", [33, 65])
def test_v_cycle3_sharded_matches_single_device(mesh, n):
    h = 1.0 / (n - 1)
    prob = p3.REFERENCE_PROBLEM_3D
    f = prob.source_grid(n) + prob.boundary_grid(n)
    u = prob.boundary_grid(n)

    want = p3.v_cycle3(u, f, h, pre=2, post=2, coarse_sweeps=10)

    zsh = NamedSharding(mesh, P("z", None, None))

    @jax.jit
    def fn(a, b):
        a = jax.lax.with_sharding_constraint(a, zsh)
        b = jax.lax.with_sharding_constraint(b, zsh)
        return p3.v_cycle3(a, b, h, pre=2, post=2, coarse_sweeps=10)

    with mesh:
        got = fn(u, f)
    # not bit-compared: the sharded compilation fuses/contracts FMAs
    # differently from the single-device one (measured: few-ulp diffs)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_chained_cycles_sharded(mesh):
    n = 33
    prob = p3.REFERENCE_PROBLEM_3D
    zsh = NamedSharding(mesh, P("z", None, None))
    u, err = p3.solve3(prob, n, cycles=6)
    h = 1.0 / (n - 1)
    f = prob.source_grid(n) + prob.boundary_grid(n)
    u0 = prob.boundary_grid(n)

    @jax.jit
    def iterate(u, f):
        u = jax.lax.with_sharding_constraint(u, zsh)
        f = jax.lax.with_sharding_constraint(f, zsh)
        return jax.lax.fori_loop(
            0, 6, lambda i, v: p3.v_cycle3(v, f, h), u)

    with mesh:
        got = iterate(u0, f)
    np.testing.assert_allclose(np.asarray(got), np.asarray(u), rtol=0,
                               atol=1e-6)
    err_sharded = float(jnp.mean(jnp.abs(got - prob.analytic_grid(n))))
    assert abs(err_sharded - err) < 1e-6
