"""The 3-D operators and engine legs vs an independent float64 numpy oracle.

models.poisson3d is the 3-D engine's whole operator layer (both engines run
it, left to XLA). Here each op — the 7-point residual, damped Jacobi,
the two error metrics, full-weighting and trilinear transfers, the
descend/ascend legs and the trigger loop — is checked against a plain
numpy float64 implementation written from the stencil's definition, at the
sizes, sweep counts and metrics the retired brick kernels were pinned at.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import multigrid_poisson as mg
from multigrid_poisson.models import poisson3d as p3
from multigrid_poisson.ops.zoom import zoom3
from multigrid_poisson.solver3 import _prolong_add3, _restrict_residual3

OMEGA = 6.0 / 7.0


def _fields(n, seed=7):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n, n, n)).astype(np.float32)
    f = rng.standard_normal((n, n, n)).astype(np.float32)
    return u, f


def _res(u, f, h):
    u = np.asarray(u, np.float64)
    f = np.asarray(f, np.float64)
    r = np.zeros_like(u)
    c = u[1:-1, 1:-1, 1:-1]
    nb = (u[:-2, 1:-1, 1:-1] + u[2:, 1:-1, 1:-1] + u[1:-1, :-2, 1:-1]
          + u[1:-1, 2:, 1:-1] + u[1:-1, 1:-1, :-2] + u[1:-1, 1:-1, 2:])
    r[1:-1, 1:-1, 1:-1] = (nb - 6.0 * c) / (h * h) - f[1:-1, 1:-1, 1:-1]
    return r


def _jacobi(u, f, h, steps, omega=OMEGA):
    u = np.asarray(u, np.float64).copy()
    for _ in range(steps):
        u = u + (omega * h * h / 6.0) * _res(u, f, h)
    return u


def _fw(d, m):
    d = np.asarray(d, np.float64)
    for ax in range(3):
        s = np.moveaxis(d, ax, 0).copy()
        t = s.copy()
        t[1:-1] = 0.25 * s[:-2] + 0.5 * s[1:-1] + 0.25 * s[2:]
        d = np.moveaxis(t, 0, ax)
    out = d[::2, ::2, ::2][:m, :m, :m].copy()
    out[[0, -1], :, :] = 0
    out[:, [0, -1], :] = 0
    out[:, :, [0, -1]] = 0
    return out


def _prolong(uc, n):
    """Trilinear 2:1 interpolation, axis by axis."""
    a = np.asarray(uc, np.float64)
    for ax in range(3):
        s = np.moveaxis(a, ax, 0)
        out = np.zeros((n,) + s.shape[1:])
        out[::2] = s
        out[1::2] = 0.5 * (s[:-1] + s[1:])
        a = np.moveaxis(out, 0, ax)
    return a


def _close(got, want, rel=1e-5):
    got = np.asarray(got, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rel * scale


@pytest.mark.parametrize("n", [17, 20, 33, 65])
def test_residual3_matches_numpy(n):
    u, f = _fields(n)
    h = 1.0 / (n - 1)
    # fp32 cancellation: |Σ nb − 6u| carries ~eps·|u|·8 of noise before /h²
    got = p3.residual3(jnp.asarray(u), jnp.asarray(f), h)
    want = _res(u, f, h)
    atol = 8 * 1.2e-7 * np.abs(u).max() / (h * h)
    assert np.abs(np.asarray(got, np.float64) - want).max() <= atol


@pytest.mark.parametrize("n,steps", [(33, 1), (33, 2), (33, 8), (65, 5),
                                     (17, 11)])
def test_jacobi3_matches_numpy(n, steps):
    u, f = _fields(n)
    u *= 1e-3      # keep the iterate near the scale Jacobi drives it to
    h = 1.0 / (n - 1)
    got, _ = p3.smooth3(jnp.asarray(u), jnp.asarray(f), h, steps=steps,
                        omega=OMEGA)
    _close(got, _jacobi(u, f, h, steps))


@pytest.mark.parametrize("steps", [1, 3])
def test_jacobi3_from_zero(steps):
    n = 33
    _, f = _fields(n)
    h = 1.0 / (n - 1)
    z = np.zeros_like(f)
    got, _ = p3.smooth3(jnp.asarray(z), jnp.asarray(f), h, steps=steps,
                        omega=OMEGA)
    _close(got, _jacobi(z, f, h, steps))


@pytest.mark.parametrize("compat", ["clean", "gpu"])
@pytest.mark.parametrize("steps", [1, 3])
def test_smoothing_error3_metrics(compat, steps):
    n = 33
    u, f = _fields(n)
    u *= 1e-3
    h = 1.0 / (n - 1)
    _, err = p3.smooth3(jnp.asarray(u), jnp.asarray(f), h, steps=steps,
                        omega=OMEGA, compat=compat)
    v = _jacobi(u, f, h, steps)
    if compat == "gpu":
        prev = _jacobi(u, f, h, steps - 1)
        want = (np.abs(v - prev)[1:-1, 1:-1, 1:-1].sum() * 6.0 / (h * h)
                / n ** 3)
    else:
        want = np.abs(_res(v, f, h)).sum() / n ** 3
    assert float(err) == pytest.approx(want, rel=2e-4)


@pytest.mark.parametrize("n", [9, 33, 129])
def test_restrict3_full_weighting_matches_numpy(n):
    m = (n + 1) // 2
    d, _ = _fields(n)
    got = p3.restrict3(jnp.asarray(d), m)
    _close(got, _fw(d, m))


@pytest.mark.parametrize("n", [9, 33, 129])
def test_zoom3_sampling_restriction_on_aligned_levels(n):
    """At 2:1 vertex alignment the bilinear zoom samples the even points."""
    m = (n + 1) // 2
    d, _ = _fields(n)
    got = zoom3(jnp.asarray(d), m, zero_boundary=True)
    want = np.asarray(d, np.float64)[::2, ::2, ::2].copy()
    want[[0, -1], :, :] = 0
    want[:, [0, -1], :] = 0
    want[:, :, [0, -1]] = 0
    _close(got, want)


@pytest.mark.parametrize("n", [9, 33, 129])
def test_prolong3_matches_numpy_and_zoom3(n):
    m = (n + 1) // 2
    uc, _ = _fields(m)
    want = _prolong(uc, n)
    _close(p3.prolong3(jnp.asarray(uc), n), want)
    _close(zoom3(jnp.asarray(uc), n), want)


def test_transfer_shape_validation():
    with pytest.raises(ValueError):
        p3.restrict3(jnp.zeros((10, 10, 10)), 5)
    with pytest.raises(ValueError):
        p3.prolong3(jnp.zeros((5, 5, 5)), 10)


@pytest.mark.parametrize("restriction", ["sampling", "full_weighting"])
@pytest.mark.parametrize("steps,from_zero", [(1, False), (3, False),
                                             (2, True)])
def test_descend_leg3_matches_numpy(restriction, steps, from_zero):
    n = 33
    m = (n + 1) // 2
    h = 1.0 / (n - 1)
    u, f = _fields(n)
    u = np.zeros_like(u) if from_zero else u * 1e-3
    su, _ = p3.smooth3(jnp.asarray(u), jnp.asarray(f), h, steps=steps,
                       omega=OMEGA)
    got = _restrict_residual3(su, jnp.asarray(f), h, m,
                              restriction=restriction)
    d = -_res(_jacobi(u, f, h, steps), f, h)
    if restriction == "full_weighting":
        want = _fw(d, m)
    else:
        want = d[::2, ::2, ::2].copy()
        want[[0, -1], :, :] = 0
        want[:, [0, -1], :] = 0
        want[:, :, [0, -1]] = 0
    _close(got, want, rel=1e-4)


@pytest.mark.parametrize("steps", [1, 2, 3])
def test_ascend_leg3_matches_numpy(steps):
    n = 33
    m = (n + 1) // 2
    h = 1.0 / (n - 1)
    u, f = _fields(n)
    u *= 1e-3
    uc, _ = _fields(m, seed=8)
    uc *= 1e-3
    uc[[0, -1], :, :] = 0
    uc[:, [0, -1], :] = 0
    uc[:, :, [0, -1]] = 0
    v = _prolong_add3(jnp.asarray(uc), jnp.asarray(u), n)
    got, _ = p3.smooth3(v, jnp.asarray(f), h, steps=steps, omega=OMEGA)
    add = np.asarray(u, np.float64).copy()
    add[1:-1, 1:-1, 1:-1] += _prolong(uc, n)[1:-1, 1:-1, 1:-1]
    _close(got, _jacobi(add, f, h, steps))


@pytest.mark.parametrize("compat", ["clean", "gpu"])
def test_trigger3_matches_numpy_loop(compat):
    """The device-side trigger loop stops at the sweep a host loop with the
    same slope rule stops at."""
    n, trigger = 17, 1e-3
    h = 1.0 / (n - 1)
    prob = p3.REFERENCE_PROBLEM_3D
    f = np.asarray(prob.source_grid(n), np.float32)
    u = np.zeros_like(f)
    got, err, k = p3.trigger_smooth3(jnp.asarray(u), jnp.asarray(f), h,
                                     trigger, OMEGA, compat, "jacobi", 500)

    def metric(new, old):
        if compat == "gpu":
            return (np.abs(new - old)[1:-1, 1:-1, 1:-1].sum() * 6.0
                    / (h * h) / n ** 3)
        return np.abs(_res(new, f, h)).sum() / n ** 3

    v = _jacobi(u, f, h, 1)
    prev, sweeps = metric(v, u), 1
    while True:
        w = _jacobi(v, f, h, 1)
        e = metric(w, v)
        v, sweeps = w, sweeps + 1
        if abs(e - prev) <= trigger:
            break
        prev = e
    assert int(k) == sweeps
    _close(got, v)


@pytest.mark.parametrize("cycle,cfg_kw", [
    ("v", {}), ("w", {}), ("fmg", {}),
    ("v", {"restriction": "full_weighting"}),
    ("v", {"compat_error": "gpu"}),
    ("trigger", {"trigger": 1e-3}),
    ("trigger", {"trigger": 1e-3, "compat_error": "gpu"}),
    ("v", {"smoother": "rbgs", "restriction": "full_weighting"}),
])
def test_compiled3_matches_solver3(cycle, cfg_kw):
    """compile_program3 vs the interpreted Solver3D across cycle shapes and
    options (aligned n=33 hierarchy, dense coarse solve)."""
    n = 33
    make = {"v": lambda: mg.v_cycle(n, n_min=5, steps=3, coarse_option=0,
                                    coarsen=3),
            "w": lambda: mg.w_cycle(n, n_min=5, steps=2, coarse_option=0,
                                    coarsen=3),
            "fmg": lambda: mg.fmg(n, n_min=5, steps=3, coarse_option=0,
                                  coarsen=3),
            "trigger": lambda: mg.v_cycle(n, n_min=5, steps=-1,
                                          coarse_option=0, coarsen=3)}
    program = make[cycle]()
    cfg = mg.SolverConfig(omega=OMEGA, collect_node_stats=False, **cfg_kw)
    rep = mg.Solver3D(p3.REFERENCE_PROBLEM_3D, cfg).run(program)
    cc = mg.compile_program3(program, p3.REFERENCE_PROBLEM_3D, cfg)
    u1, _ = cc(*cc.init())
    np.testing.assert_allclose(np.asarray(u1), np.asarray(rep.u), rtol=0,
                               atol=1e-5)
