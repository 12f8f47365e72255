"""The compiled engine's padded-layout ops vs the ops.stencils oracle.

These are the shapes the engine's smoother, residual, error metrics and
descend/ascend legs were pinned at when they ran as fused kernels — single
and odd sizes (33, 129, 257, 900, 1030, 1031, 2049), sweep counts past the
old per-pass caps (7, 8, 11), all three error metrics, both restrictions,
and correction levels entered from zero. The engine now runs them as plain
jnp ops left to XLA (compiled._sweeps / _smooth_traced / _restrict and
ops.padded); the oracle is the unpadded reference-semantics layer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import multigrid_poisson as mg
from multigrid_poisson import compiled as C
from multigrid_poisson.ops import layout, stencils
from multigrid_poisson.ops import padded as P
from multigrid_poisson.ops.zoom import zoom
from multigrid_poisson.solver import _prolong_add


def _fields(rng, n):
    u = jnp.asarray(rng.standard_normal((n, n)), jnp.float32)
    f = jnp.asarray(rng.standard_normal((n, n)), jnp.float32)
    return u, f


def _cfg(**kw):
    return mg.SolverConfig(**kw)


def _assert_pad_zero(a, n):
    pad = np.asarray(a).copy()
    pad[:n, :n] = 0
    assert not pad.any()


@pytest.mark.parametrize("n,steps", [
    (33, 2), (257, 3), (1030, 8), (900, 5), (2049, 11),
])
def test_sweeps_match_oracle(rng, n, steps):
    u, f = _fields(rng, n)
    h = 1.0 / (n - 1)
    got = C._sweeps(layout.pad_grid(u), layout.pad_grid(f), h, n, steps,
                    _cfg())
    want, _ = stencils.smooth(u, f, h, steps=steps)
    np.testing.assert_allclose(np.asarray(layout.unpad_grid(got, n)),
                               np.asarray(want), rtol=0, atol=1e-6)
    _assert_pad_zero(got, n)


def test_sweeps_damped(rng):
    n, steps = 129, 4
    u, f = _fields(rng, n)
    h = 1.0 / (n - 1)
    got = C._sweeps(layout.pad_grid(u), layout.pad_grid(f), h, n, steps,
                    _cfg(omega=0.8))
    want, _ = stencils.smooth(u, f, h, steps=steps, omega=0.8)
    np.testing.assert_allclose(np.asarray(layout.unpad_grid(got, n)),
                               np.asarray(want), rtol=0, atol=1e-6)


def test_sweeps_boundary_frozen(rng):
    n = 257
    u, f = _fields(rng, n)
    got = layout.unpad_grid(C._sweeps(layout.pad_grid(u), layout.pad_grid(f),
                                      1.0 / (n - 1), n, 5, _cfg()), n)
    for sl in (np.s_[0, :], np.s_[-1, :], np.s_[:, 0], np.s_[:, -1]):
        np.testing.assert_array_equal(np.asarray(got[sl]), np.asarray(u[sl]))


@pytest.mark.parametrize("n", [64, 257, 1030])
@pytest.mark.parametrize("negate", [False, True])
def test_residual_matches_oracle(rng, n, negate):
    u, f = _fields(rng, n)
    h = 1.0 / (n - 1)
    got = P.residual_p(layout.pad_grid(u), layout.pad_grid(f), h, n)
    want = stencils.residual(u, f, h)
    if negate:
        got, want = -got, -want
    # naive fp32 residuals in different association orders differ by
    # ~eps·|u|·k/h² (the cancellation noise)
    atol = 8 * 1.2e-7 * float(jnp.abs(u).max()) / (h * h)
    np.testing.assert_allclose(np.asarray(layout.unpad_grid(got, n)),
                               np.asarray(want), rtol=0, atol=atol)
    _assert_pad_zero(got, n)


@pytest.mark.parametrize("n,steps", [
    (257, 1), (257, 3), (1030, 7), (1030, 8), (2049, 11),
])
@pytest.mark.parametrize("compat", [True, False, "gpu"])
def test_smoothing_error_matches_oracle(rng, n, steps, compat):
    """The engine's smoothing + error metric (all three reference metrics)
    vs stencils.smooth's after-the-fact metric."""
    u, f = _fields(rng, n)
    h = 1.0 / (n - 1)
    got_u, got_err = C._smooth_traced(
        layout.pad_grid(u), layout.pad_grid(f), h, n, steps,
        _cfg(omega=0.8, compat_error=compat), want_err=True)
    want_u, want_err = stencils.smooth(u, f, h, steps=steps, omega=0.8,
                                       compat=compat)
    np.testing.assert_allclose(np.asarray(layout.unpad_grid(got_u, n)),
                               np.asarray(want_u), rtol=0, atol=1e-6)
    assert float(got_err) == pytest.approx(float(want_err), rel=2e-5)


@pytest.mark.parametrize("compat,steps", [("gpu", 1), ("gpu", 3),
                                          (True, 1), (True, 3)])
def test_from_zero_matches_oracle(rng, compat, steps):
    """A correction level entered from u ≡ 0 takes the closed-form first
    sweep; iterate and metric match smoothing the zero grid."""
    n, h = 257, 1.0 / 256
    f = jnp.asarray(rng.standard_normal((n, n)), jnp.float32)
    fp = layout.pad_grid(f)
    got_u, got_err = C._smooth_traced(
        jnp.zeros_like(fp), fp, h, n, steps, _cfg(compat_error=compat),
        want_err=True, from_zero=True)
    want_u, want_err = stencils.smooth(jnp.zeros_like(f), f, h, steps=steps,
                                       compat=compat)
    np.testing.assert_allclose(np.asarray(layout.unpad_grid(got_u, n)),
                               np.asarray(want_u), rtol=0, atol=1e-6)
    assert float(got_err) == pytest.approx(float(want_err), rel=2e-5)


def _full_weighting_oracle(d, m):
    """Separable [¼, ½, ¼]² smoothing sampled at even points, zero
    boundary (numpy, float64)."""
    d = np.asarray(d, np.float64)
    s = d.copy()
    s[1:-1, :] = 0.25 * d[:-2, :] + 0.5 * d[1:-1, :] + 0.25 * d[2:, :]
    t = s.copy()
    t[:, 1:-1] = 0.25 * s[:, :-2] + 0.5 * s[:, 1:-1] + 0.25 * s[:, 2:]
    out = t[::2, ::2][:m, :m].copy()
    out[0, :] = out[-1, :] = out[:, 0] = out[:, -1] = 0.0
    return out


@pytest.mark.parametrize("n,steps", [(129, 3), (257, 1), (1031, 6)])
@pytest.mark.parametrize("restriction", ["sampling", "full_weighting"])
@pytest.mark.parametrize("from_zero", [False, True])
def test_descend_leg_matches_oracle(rng, n, steps, restriction, from_zero):
    """Descend leg (sweeps + residual + restriction) on a 2:1-aligned
    hierarchy vs the oracle smoother, residual and restriction."""
    m = (n + 1) // 2
    h = 1.0 / (n - 1)
    u0 = (jnp.zeros((n, n), jnp.float32) if from_zero
          else jnp.asarray(rng.standard_normal((n, n)), jnp.float32))
    f = jnp.asarray(rng.standard_normal((n, n)), jnp.float32)
    cfg = _cfg(omega=0.8, restriction=restriction)
    got_u, err = C._smooth_traced(layout.pad_grid(u0), layout.pad_grid(f),
                                  h, n, steps, cfg, want_err=True,
                                  from_zero=from_zero)
    got_fc = C._restrict(P.residual_p(got_u, layout.pad_grid(f), h, n), n, m,
                         cfg)

    want_u, want_err = stencils.smooth(u0, f, h, steps=steps, omega=0.8)
    np.testing.assert_allclose(np.asarray(layout.unpad_grid(got_u, n)),
                               np.asarray(want_u), rtol=0, atol=1e-6)
    d = stencils.residual(want_u, f, h)
    if restriction == "full_weighting":
        want_fc = _full_weighting_oracle(-d, m)
    else:
        want_fc = np.asarray(zoom(-d, m, zero_boundary=True))
    atol = 2e-6 * float(jnp.abs(d).max() + 1)
    np.testing.assert_allclose(np.asarray(layout.unpad_grid(got_fc, m)),
                               want_fc, rtol=0, atol=atol)
    _assert_pad_zero(got_fc, m)
    assert float(err) == pytest.approx(float(want_err), rel=1e-4)


@pytest.mark.parametrize("n,steps", [(129, 3), (257, 1), (1031, 8)])
@pytest.mark.parametrize("want_err", [False, True])
def test_ascend_leg_matches_oracle(rng, n, steps, want_err):
    """Ascend leg (prolongation + interior add + post-sweeps) vs the oracle
    prolong-add and smoother."""
    m = (n + 1) // 2
    h = 1.0 / (n - 1)
    uf, f = _fields(rng, n)
    uc = jnp.asarray(rng.standard_normal((m, m)), jnp.float32)
    uc = uc.at[0, :].set(0).at[-1, :].set(0).at[:, 0].set(0).at[:, -1].set(0)
    ufp = layout.pad_grid(uf)
    corr = P.zoom_take_p(layout.pad_grid(uc), m, n, ufp.shape)
    got_u, err = C._smooth_traced(P.add_correction_p(ufp, corr, n),
                                  layout.pad_grid(f), h, n, steps,
                                  _cfg(omega=0.8), want_err=want_err)
    want_u, want_e = stencils.smooth(_prolong_add(uc, uf, n), f, h,
                                     steps=steps, omega=0.8)
    np.testing.assert_allclose(np.asarray(layout.unpad_grid(got_u, n)),
                               np.asarray(want_u), rtol=0, atol=1e-5)
    if want_err:
        assert float(err) == pytest.approx(float(want_e), rel=1e-4)
    else:
        assert err is None


def test_zero_steps_is_identity(rng):
    n = 65
    up = layout.pad_grid(jnp.asarray(rng.standard_normal((n, n)),
                                     jnp.float32))
    out = C._sweeps(up, up, 1.0 / (n - 1), n, 0, _cfg())
    np.testing.assert_array_equal(np.asarray(out), np.asarray(up))


@pytest.mark.parametrize("compat", [True, False, "gpu"])
def test_trigger_loop_matches_oracle(rng, compat):
    """The compiled engine's device-side trigger loop stops at the sweep the
    interpreted engine's loop stops at, with the same final metric."""
    from multigrid_poisson.solver import _trigger_smooth

    n, h = 129, 1.0 / 128
    u, f = _fields(rng, n)
    cfg = _cfg(omega=0.9, compat_error=compat, trigger=1e-2,
               max_trigger_sweeps=200)
    got_u, got_err = jax.jit(lambda a, b: C._trigger_smooth_traced(
        a, b, h, n, cfg))(layout.pad_grid(u), layout.pad_grid(f))
    want_u, want_err, _ = _trigger_smooth(u, f, h, cfg.trigger, cfg.omega,
                                          compat, "jacobi", 200)
    np.testing.assert_allclose(np.asarray(layout.unpad_grid(got_u, n)),
                               np.asarray(want_u), rtol=0, atol=1e-5)
    assert float(got_err) == pytest.approx(float(want_err), rel=1e-4)


@pytest.mark.parametrize("state", ["df32", "tw32"])
def test_multiword_residual_vs_f64_truth(rng, state):
    """refine.residual_df_p / residual_tw_p (the multi-word residuals the
    refinement loop runs, left to XLA) vs the float64 residual of the
    summed words."""
    from multigrid_poisson.refine import residual_df_p, residual_tw_p

    n, h = 257, 1.0 / 256
    words = [layout.pad_grid(jnp.asarray(
        rng.standard_normal((n, n)) * s, jnp.float32))
        for s in (1e-3, 1e-11, 1e-19)]
    f = layout.pad_grid(jnp.asarray(rng.standard_normal((n, n)),
                                    jnp.float32))
    if state == "df32":
        words = words[:2]
        got = residual_df_p(*words, f, h, n)
    else:
        got = residual_tw_p(*words, f, h, n)
    u64 = sum(np.asarray(w, np.float64) for w in words)
    want = P.residual_p(jnp.asarray(u64), jnp.asarray(f, jnp.float64), h, n)
    scale = float(np.abs(np.asarray(want)).max())
    assert float(np.abs(np.asarray(got) - np.asarray(want)).max()) \
        <= 1e-6 * scale


def _dd_residual(words, f, h, n):
    """Float64 double-double residual of Σ words (error-free conversion,
    two-sum stencil chain) — the independent reference."""
    def ts(a, b):
        s = a + b
        bb = s - a
        return s, (a - (s - bb)) + (b - bb)

    hi = words[0].astype(np.float64)
    lo = np.zeros_like(hi)
    for w in words[1:]:
        hi, e = ts(hi, w.astype(np.float64))
        lo = lo + e
    hi, lo = ts(hi, lo)
    nb = [np.roll(hi, k, ax) for ax in (0, 1) for k in (1, -1)]
    s, acc = ts(nb[0], nb[1])
    for t in (nb[2], nb[3], -hi, -hi, -hi, -hi):
        s, e = ts(s, t)
        acc = acc + e
    slo = sum(np.roll(lo, k, ax) for ax in (0, 1) for k in (1, -1)) - 4 * lo
    r = (s / (h * h) - f.astype(np.float64)) + (acc + slo) / (h * h)
    mask = np.zeros(hi.shape, bool)
    mask[1:n - 1, 1:n - 1] = True
    return np.where(mask, r, 0.0)


@pytest.mark.parametrize("hinv", [4096, 8192])
def test_tw_residual_at_fine_spacing(hinv):
    """At h = 1/8192 the stencil sum of the second word (rounding noise,
    ~eps·|u|) rivals h²·f, so the large terms no longer cancel within a
    factor of two; the triple-word residual must still match the
    double-double reference to one fp32 rounding of the result. A 2049²
    window of the reference problem's solution at that spacing, centred
    where |f| ~ 1."""
    from multigrid_poisson.refine import residual_tw_p

    n = 2049
    h = 1.0 / hinv
    x = 0.375 + np.arange(n) * h
    X, Y = np.meshgrid(x, x, indexing="xy")
    u = np.exp(X - Y) * X * (1 - X) * Y * (1 - Y)
    f = 2.0 * X * (Y - 1.0) * (Y - 2.0 * X + X * Y + 2.0) * np.exp(X - Y)
    w0 = u.astype(np.float32)
    w1 = (u - w0).astype(np.float32)
    w2 = (u - w0 - w1).astype(np.float32)
    pw = [layout.pad_grid(jnp.asarray(w)) for w in (w0, w1, w2)]
    fp = layout.pad_grid(jnp.asarray(f.astype(np.float32)))
    got = np.asarray(residual_tw_p(*pw, fp, h, n), np.float64)
    want = _dd_residual([np.asarray(w) for w in pw], np.asarray(fp), h, n)
    assert float(np.abs(got - want).max()) <= 1e-6 * float(np.abs(want).max())
