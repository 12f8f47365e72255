"""Padded-layout ops vs the unpadded oracle ops (ops.stencils / ops.zoom).

Every padded op must match its oracle exactly on the true (n, n) corner and
preserve the layout invariant (pad cells zero) — the hot path depends on it
(the stencils' rolls assume pad rows are zero; zoom matmuls assume zero
extension).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from multigrid_poisson.ops import layout, padded, stencils
from multigrid_poisson.ops.zoom import zoom

SIZES = [17, 64, 129, 257]


def _pads(rng, n, dtype=jnp.float32):
    u = jnp.asarray(rng.standard_normal((n, n)), dtype)
    f = jnp.asarray(rng.standard_normal((n, n)), dtype)
    return u, f, layout.pad_grid(u), layout.pad_grid(f)


def _pad_zeros(a, n):
    out = np.asarray(a).copy()
    out[:n, :n] = 0
    return out


@pytest.mark.parametrize("n", SIZES)
def test_padded_shapes(n):
    rp, cp = layout.padded_shape(n)
    assert rp % layout.ROW_PAD == 0 and cp % 128 == 0 and rp >= n and cp >= n
    assert rp - n < layout.ROW_PAD and cp - n < 128


@pytest.mark.parametrize("n", SIZES)
def test_jacobi_matches_oracle(rng, n):
    u, f, up, fp = _pads(rng, n)
    h = 1.0 / (n - 1)
    got = padded.jacobi_sweep_p(up, fp, h, n, omega=0.8)
    want = stencils.jacobi_sweep(u, f, h, omega=0.8)
    np.testing.assert_array_equal(np.asarray(layout.unpad_grid(got, n)),
                                  np.asarray(want))
    assert not _pad_zeros(got, n).any()


@pytest.mark.parametrize("n", SIZES)
def test_rbgs_matches_oracle(rng, n):
    u, f, up, fp = _pads(rng, n)
    h = 1.0 / (n - 1)
    got = padded.redblack_gs_sweep_p(up, fp, h, n)
    want = stencils.redblack_gs_sweep(u, f, h)
    np.testing.assert_allclose(np.asarray(layout.unpad_grid(got, n)),
                               np.asarray(want), rtol=0, atol=1e-6)
    assert not _pad_zeros(got, n).any()


@pytest.mark.parametrize("n", SIZES)
def test_residual_matches_oracle(rng, n):
    u, f, up, fp = _pads(rng, n)
    h = 1.0 / (n - 1)
    got = padded.residual_p(up, fp, h, n)
    want = stencils.residual(u, f, h)
    scale = float(jnp.abs(want).max())
    np.testing.assert_allclose(np.asarray(layout.unpad_grid(got, n)),
                               np.asarray(want), rtol=1e-6, atol=1e-5 * scale)
    assert not _pad_zeros(got, n).any()


@pytest.mark.parametrize("compat", [True, False])
def test_smoothing_error_matches_oracle(rng, compat):
    n = 65
    u, f, up, fp = _pads(rng, n)
    h = 1.0 / (n - 1)
    got = float(padded.smoothing_error_p(up, fp, h, n, compat=compat))
    want = float(stencils.smoothing_error(u, f, h, compat=compat))
    assert got == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("n,m", [(65, 33), (33, 65), (64, 32), (129, 64), (65, 60)])
def test_zoom_matches_oracle(rng, n, m):
    u, _, up, _ = _pads(rng, n)
    got = padded.zoom_p(up, n, m, layout.padded_shape(m), zero_boundary=True)
    want = zoom(u, m, zero_boundary=True)
    np.testing.assert_allclose(np.asarray(layout.unpad_grid(got, m)),
                               np.asarray(want), rtol=1e-5, atol=1e-6)
    assert not _pad_zeros(got, m).any()


def test_zoom_no_zero_boundary_keeps_invariant(rng):
    n, m = 33, 65
    u, _, up, _ = _pads(rng, n)
    got = padded.zoom_p(up, n, m, layout.padded_shape(m))
    want = zoom(u, m)
    np.testing.assert_allclose(np.asarray(layout.unpad_grid(got, m)),
                               np.asarray(want), rtol=1e-5, atol=1e-6)
    assert not _pad_zeros(got, m).any()


def test_add_correction_interior_only(rng):
    n = 33
    u, f, up, fp = _pads(rng, n)
    got = padded.add_correction_p(up, fp, n)
    inner = np.asarray(layout.unpad_grid(got, n))
    want = np.asarray(u).copy()
    want[1:-1, 1:-1] += np.asarray(f)[1:-1, 1:-1]
    np.testing.assert_array_equal(inner, want)
    assert not _pad_zeros(got, n).any()


def test_mean_abs_error_p(rng):
    n = 33
    u, f, up, fp = _pads(rng, n)
    got = float(padded.mean_abs_error_p(up, fp, n))
    want = float(jnp.mean(jnp.abs(u - f)))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("n,m", [(257, 129), (129, 257), (1025, 513),
                                 (200, 67), (67, 200)])
@pytest.mark.parametrize("zero_boundary", [False, True])
def test_zoom_forms_agree(rng, n, m, zero_boundary):
    """The matmul zoom (SolverConfig.zoom="matmul") and the gather zoom
    ("take") are the same bilinear operator: they agree to fp32 rounding.
    A matmul run at reduced input precision (TF32 keeps ~3 digits) would
    miss by ~1e-3."""
    u = layout.pad_grid(jnp.asarray(rng.standard_normal((n, n)), jnp.float32))
    shape = layout.padded_shape(m)
    a = padded.zoom_p(u, n, m, shape, zero_boundary=zero_boundary)
    b = padded.zoom_take_p(u, n, m, shape, zero_boundary=zero_boundary)
    scale = float(jnp.abs(b).max())
    assert float(jnp.abs(a - b).max()) <= 4 * 1.2e-7 * scale


def test_zoom_p_matmuls_request_highest_precision():
    import jax

    n, m = 33, 17
    u = jnp.zeros(layout.padded_shape(n), jnp.float32)
    jaxpr = jax.make_jaxpr(
        lambda x: padded.zoom_p(x, n, m, layout.padded_shape(m)))(u)
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert len(dots) == 2
    for e in dots:
        assert str(e.params["precision"]).count("HIGHEST") == 2
