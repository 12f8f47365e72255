"""Oracle tests: jnp stencil ops vs straightforward numpy implementations.

These play the role of the reference's testFunction/ harnesses (CPU oracle vs
GPU kernel), but with asserts and tolerances instead of printed grids.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from multigrid_poisson.ops import (
    add_correction,
    jacobi_sweep,
    mean_abs_interior_residual,
    redblack_gs_sweep,
    residual,
    smooth,
    smoothing_error,
)


def np_residual(u, f, h):
    n = u.shape[0]
    r = np.zeros_like(u)
    for iy in range(1, n - 1):
        for ix in range(1, n - 1):
            r[iy, ix] = (
                u[iy + 1, ix] + u[iy - 1, ix] + u[iy, ix + 1] + u[iy, ix - 1]
                - 4.0 * u[iy, ix]
            ) / (h * h) - f[iy, ix]
    return r


def np_jacobi(u, f, h):
    n = u.shape[0]
    out = u.copy()
    for iy in range(1, n - 1):
        for ix in range(1, n - 1):
            out[iy, ix] = u[iy, ix] + 0.25 * (
                u[iy + 1, ix] + u[iy - 1, ix] + u[iy, ix + 1] + u[iy, ix - 1]
                - 4.0 * u[iy, ix] - h * h * f[iy, ix]
            )
    return out


def np_rbgs(u, f, h):
    n = u.shape[0]
    out = u.copy()
    for parity in (0, 1):
        for iy in range(1, n - 1):
            for ix in range(1, n - 1):
                if (iy + ix) % 2 == parity:
                    out[iy, ix] = 0.25 * (
                        out[iy + 1, ix] + out[iy - 1, ix]
                        + out[iy, ix + 1] + out[iy, ix - 1]
                        - h * h * f[iy, ix]
                    )
    return out


def np_smoothing_error_compat(u, f, h):
    """The reference's color-bugged metric: even-color |residual| counted twice / N²."""
    n = u.shape[0]
    r = np_residual(u, f, h)
    s = 0.0
    for iy in range(1, n - 1):
        for ix in range(1, n - 1):
            if (iy + ix) % 2 == 0:
                s += abs(r[iy, ix])
    return 2.0 * s / (n * n)


@pytest.fixture
def fields(rng):
    n, h = 17, 1.0 / 16
    u = rng.random((n, n))
    f = rng.random((n, n))
    return u, f, h


def test_residual_matches_numpy(fields):
    u, f, h = fields
    got = np.asarray(residual(jnp.asarray(u), jnp.asarray(f), h))
    np.testing.assert_allclose(got, np_residual(u, f, h), rtol=1e-12, atol=1e-12)


def test_residual_zero_boundary(fields):
    u, f, h = fields
    r = np.asarray(residual(jnp.asarray(u), jnp.asarray(f), h))
    assert np.all(r[0, :] == 0) and np.all(r[-1, :] == 0)
    assert np.all(r[:, 0] == 0) and np.all(r[:, -1] == 0)


def test_jacobi_sweep_matches_numpy(fields):
    u, f, h = fields
    got = np.asarray(jacobi_sweep(jnp.asarray(u), jnp.asarray(f), h))
    np.testing.assert_allclose(got, np_jacobi(u, f, h), rtol=1e-12, atol=1e-12)
    # boundary untouched
    np.testing.assert_array_equal(got[0, :], u[0, :])
    np.testing.assert_array_equal(got[:, -1], u[:, -1])


def test_redblack_gs_sweep_matches_numpy(fields):
    u, f, h = fields
    got = np.asarray(redblack_gs_sweep(jnp.asarray(u), jnp.asarray(f), h))
    np.testing.assert_allclose(got, np_rbgs(u, f, h), rtol=1e-12, atol=1e-12)


def test_smoothing_error_compat_matches_reference_metric(fields):
    u, f, h = fields
    got = float(smoothing_error(jnp.asarray(u), jnp.asarray(f), h, compat=True))
    assert got == pytest.approx(np_smoothing_error_compat(u, f, h), rel=1e-12)


def np_gpu_smoothing_error(u_new, u_old, h):
    """Direct transcription of ker_Smoothing_GPU's metric: interior
    |U_new − U_old|·4/h² summed, host divides by N² (MG_solver_GPU.cu:633,
    1266-1272)."""
    n = u_new.shape[0]
    s = 0.0
    for iy in range(1, n - 1):
        for ix in range(1, n - 1):
            s += abs(u_new[iy, ix] - u_old[iy, ix]) * 4.0 / (h * h)
    return s / (n * n)


def test_gpu_smoothing_error_matches_reference_formula(fields):
    from multigrid_poisson.ops.stencils import gpu_smoothing_error

    u, f, h = fields
    u_new = np_jacobi(u, f, h)
    got = float(gpu_smoothing_error(jnp.asarray(u_new), jnp.asarray(u), h))
    assert got == pytest.approx(np_gpu_smoothing_error(u_new, u, h), rel=1e-12)


def test_smooth_gpu_metric_is_last_sweep_delta(fields):
    """smooth(compat='gpu') returns the GPU ping-pong metric of the FINAL
    sweep (the reference overwrites err each kernel launch,
    MG_solver_GPU.cu:1233-1245), which for Jacobi equals
    mean |residual(u_before_last)| over N²."""
    u, f, h = fields
    uj, err = smooth(jnp.asarray(u), jnp.asarray(f), h, steps=3, compat="gpu")
    u1 = np_jacobi(np_jacobi(u, f, h), f, h)
    u2 = np_jacobi(u1, f, h)
    np.testing.assert_allclose(np.asarray(uj), u2, rtol=1e-12, atol=1e-12)
    assert float(err) == pytest.approx(np_gpu_smoothing_error(u2, u1, h),
                                       rel=1e-10)
    # ω=1 Jacobi identity: |ΔU|·4/h² == |residual(old)|
    n = u.shape[0]
    r = np.abs(np_residual(u1, f, h))[1:-1, 1:-1].sum() / (n * n)
    assert float(err) == pytest.approx(r, rel=1e-10)


def test_smooth_multi_step_equals_repeated_sweeps(fields):
    u, f, h = fields
    uj, err = smooth(jnp.asarray(u), jnp.asarray(f), h, steps=3)
    expect = u.copy()
    for _ in range(3):
        expect = np_jacobi(expect, f, h)
    np.testing.assert_allclose(np.asarray(uj), expect, rtol=1e-12, atol=1e-12)
    assert float(err) == pytest.approx(np_smoothing_error_compat(expect, f, h), rel=1e-12)


def test_smooth_reduces_residual(fields):
    u, f, h = fields
    r0 = float(mean_abs_interior_residual(jnp.asarray(u), jnp.asarray(f), h))
    u5, _ = smooth(jnp.asarray(u), jnp.asarray(f), h, steps=20)
    r5 = float(mean_abs_interior_residual(u5, jnp.asarray(f), h))
    assert r5 < r0


def test_rbgs_smoother_converges_faster_than_jacobi(fields):
    u, f, h = fields
    uj, _ = smooth(jnp.asarray(u), jnp.asarray(f), h, steps=10, smoother="jacobi")
    ug, _ = smooth(jnp.asarray(u), jnp.asarray(f), h, steps=10, smoother="rbgs")
    rj = float(mean_abs_interior_residual(uj, jnp.asarray(f), h))
    rg = float(mean_abs_interior_residual(ug, jnp.asarray(f), h))
    assert rg < rj


def test_add_correction(fields):
    u, f, _ = fields
    got = np.asarray(add_correction(jnp.asarray(u), jnp.asarray(f)))
    np.testing.assert_allclose(got, u + f)
