"""Compensated-residual tests: fp32 double-float evaluation vs float64 truth.

The decisive property: for an fp32 iterate at large N, the *naive* fp32
residual is eps/h²-noise-dominated while the compensated fp32 residual
matches the float64-evaluated residual of the same fp32 values. This is the
framework's inversion of the reference's precision layer (C15 in SURVEY.md):
fp32 storage + error-free transformations instead of fp64 arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from multigrid_poisson.ops import layout, padded, precision, stencils


def _f64_residual(u32, f32, h):
    """Ground truth: residual of the fp32 values evaluated in float64."""
    u = np.asarray(u32, np.float64)
    f = np.asarray(f32, np.float64)
    r = np.zeros_like(u)
    r[1:-1, 1:-1] = (u[:-2, 1:-1] + u[2:, 1:-1] + u[1:-1, :-2] + u[1:-1, 2:]
                     - 4.0 * u[1:-1, 1:-1]) / (h * h) - f[1:-1, 1:-1]
    return r


def _smooth_iterate(n, dtype=jnp.float32):
    """A realistic smooth iterate + RHS at grid size n (not white noise —
    cancellation only bites when neighboring values agree to ~h²)."""
    import multigrid_poisson as mg
    spec = mg.GridSpec(n)
    u = mg.REFERENCE_PROBLEM.analytic_grid(spec, dtype)
    f = mg.REFERENCE_PROBLEM.source_grid(spec, dtype)
    return u, f, spec.h


@pytest.mark.parametrize("n", [257, 1025])
def test_compensated_matches_f64_truth(n):
    u, f, h = _smooth_iterate(n)
    truth = _f64_residual(u, f, h)
    naive = np.asarray(stencils.residual(u, f, h), np.float64)
    comp = np.asarray(precision.residual_compensated(u, f, h), np.float64)

    scale = np.abs(truth).max() + 1.0
    comp_err = np.abs(comp - truth).max()
    naive_err = np.abs(naive - truth).max()
    # compensated ≈ f64 truth...
    assert comp_err <= max(1e-5 * scale, 1e-3)
    # ...and at this size the naive fp32 evaluation is measurably worse
    assert comp_err < naive_err / 4


def test_naive_noise_grows_with_n_but_compensated_does_not():
    errs = {}
    for n in (129, 513):
        u, f, h = _smooth_iterate(n)
        truth = _f64_residual(u, f, h)
        naive = np.asarray(stencils.residual(u, f, h), np.float64)
        comp = np.asarray(precision.residual_compensated(u, f, h), np.float64)
        errs[n] = (np.abs(naive - truth).max(), np.abs(comp - truth).max())
    # naive noise scales ~N² (eps/h²); compensated stays flat
    assert errs[513][0] > 4 * errs[129][0]
    assert errs[513][1] < 10 * errs[129][1] + 1e-6


def test_padded_compensated_matches_unpadded():
    n = 257
    u, f, h = _smooth_iterate(n)
    up, fp = layout.pad_grid(u), layout.pad_grid(f)
    got = layout.unpad_grid(padded.residual_compensated_p(up, fp, h, n), n)
    want = precision.residual_compensated(u, f, h)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def test_relative_residual_norm_consistency():
    n = 257
    u, f, h = _smooth_iterate(n)
    up, fp = layout.pad_grid(u), layout.pad_grid(f)
    a = float(precision.relative_residual_norm_compensated(u, f, h))
    b = float(padded.relative_residual_norm_p(up, fp, h, n))
    assert a == pytest.approx(b, rel=1e-4)


def test_two_sum_exactness():
    rng = np.random.default_rng(7)
    a = jnp.asarray(rng.standard_normal(1000) * 1e6, jnp.float32)
    b = jnp.asarray(rng.standard_normal(1000), jnp.float32)
    s, e = precision.two_sum(a, b)
    exact = np.asarray(a, np.float64) + np.asarray(b, np.float64)
    recon = np.asarray(s, np.float64) + np.asarray(e, np.float64)
    np.testing.assert_array_equal(recon, exact)
