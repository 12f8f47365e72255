"""3-D multigrid scaffold: ops vs numpy truth + manufactured-solution
convergence (capability extension beyond the 2-D reference)."""

import jax.numpy as jnp
import numpy as np
import pytest

from multigrid_poisson.models import poisson3d as p3


def np_residual3(u, f, h):
    r = np.zeros_like(u)
    r[1:-1, 1:-1, 1:-1] = (
        u[:-2, 1:-1, 1:-1] + u[2:, 1:-1, 1:-1]
        + u[1:-1, :-2, 1:-1] + u[1:-1, 2:, 1:-1]
        + u[1:-1, 1:-1, :-2] + u[1:-1, 1:-1, 2:]
        - 6 * u[1:-1, 1:-1, 1:-1]) / h**2 - f[1:-1, 1:-1, 1:-1]
    return r


def test_residual3_matches_numpy(rng):
    n, h = 9, 1.0 / 8
    u = rng.random((n, n, n))
    f = rng.random((n, n, n))
    got = np.asarray(p3.residual3(jnp.asarray(u), jnp.asarray(f), h))
    np.testing.assert_allclose(got, np_residual3(u, f, h), rtol=1e-12)


def test_jacobi3_reduces_residual(rng):
    n, h = 17, 1.0 / 16
    u = jnp.asarray(rng.random((n, n, n)), jnp.float32)
    f = jnp.zeros((n, n, n), jnp.float32)
    r0 = float(jnp.abs(p3.residual3(u, f, h)).mean())
    for _ in range(20):
        u = p3.jacobi_sweep3(u, f, h)
    r1 = float(jnp.abs(p3.residual3(u, f, h)).mean())
    assert r1 < 0.3 * r0


def test_transfer_operators_roundtrip(rng):
    """Prolongation is exact on trilinear functions; restriction is its
    (scaled) adjoint-like partner with zero boundary."""
    n, m = 17, 9
    x = np.linspace(0, 1, m)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    uc = jnp.asarray(2 * X + 3 * Y - Z, jnp.float32)
    fine = np.asarray(p3.prolong3(uc, n))
    xf = np.linspace(0, 1, n)
    XF, YF, ZF = np.meshgrid(xf, xf, xf, indexing="ij")
    np.testing.assert_allclose(fine, 2 * XF + 3 * YF - ZF, atol=1e-6)

    d = jnp.asarray(rng.random((n, n, n)), jnp.float32)
    r = np.asarray(p3.restrict3(d, m))
    assert r.shape == (m, m, m)
    assert np.all(r[0] == 0) and np.all(r[:, :, -1] == 0)


def test_vcycle3_converges_to_discretization_floor():
    n = 33
    u, err = p3.solve3(p3.REFERENCE_PROBLEM_3D, n, cycles=10)
    # discretization error of the 7-point stencil at h=1/32 is ~h²·|u⁗|
    assert err is not None and err < 5e-3
    # algebraic convergence: residual far below the first-cycle level
    h = 1.0 / (n - 1)
    f = p3.REFERENCE_PROBLEM_3D.source_grid(n)
    r = float(jnp.abs(p3.residual3(u, f, h)).mean())
    f_scale = float(jnp.abs(f).mean())
    assert r < 1e-3 * f_scale


def test_vcycle3_contracts():
    n = 33
    h = 1.0 / (n - 1)
    f = p3.REFERENCE_PROBLEM_3D.source_grid(n)
    u = jnp.zeros((n, n, n), jnp.float32)
    norms = []
    for _ in range(4):
        u = p3.v_cycle3(u, f, h)
        norms.append(float(jnp.linalg.norm(jnp.ravel(p3.residual3(u, f, h)))))
    assert norms[-1] < 0.05 * norms[0]
