"""Exact coarse solver tests: dense LU vs red-black Gauss-Seidel vs analytic."""

import numpy as np
import jax.numpy as jnp
import pytest

from multigrid_poisson import GridSpec, REFERENCE_PROBLEM
from multigrid_poisson.ops import (
    dense_solve,
    exact_solve,
    gauss_seidel_solve,
    mean_abs_interior_residual,
    residual,
)


@pytest.fixture
def small_problem():
    spec = GridSpec(n=17)
    f = REFERENCE_PROBLEM.source_grid(spec, dtype=jnp.float64)
    return spec, f


def test_dense_solve_satisfies_equations(small_problem):
    spec, f = small_problem
    u = dense_solve(f, spec.h)
    r = float(mean_abs_interior_residual(u, f, spec.h))
    assert r < 1e-9
    # Dirichlet boundary honored (F boundary = 0 → identity rows give u = 0)
    un = np.asarray(u)
    assert np.allclose(un[0, :], 0) and np.allclose(un[:, -1], 0)


def test_dense_solve_close_to_analytic(small_problem):
    spec, f = small_problem
    u = dense_solve(f, spec.h)
    ua = REFERENCE_PROBLEM.analytic_grid(spec, dtype=jnp.float64)
    # discretization error is O(h²) ≈ 4e-3 at n=17; exact solve must be well under
    assert float(jnp.mean(jnp.abs(u - ua))) < 5e-4


def test_gauss_seidel_reaches_target(small_problem):
    spec, f = small_problem
    u, err, iters = gauss_seidel_solve(f, spec.h, target_error=1e-10)
    assert float(err) <= 1e-10
    assert int(iters) > 0
    r = float(mean_abs_interior_residual(u, f, spec.h))
    assert r <= 1e-10


def test_gauss_seidel_matches_dense(small_problem):
    spec, f = small_problem
    ud = dense_solve(f, spec.h)
    ug, _, _ = gauss_seidel_solve(f, spec.h, target_error=1e-12)
    np.testing.assert_allclose(np.asarray(ug), np.asarray(ud), atol=1e-8)


def test_gauss_seidel_max_iters_backstop(small_problem):
    spec, f = small_problem
    _, err, iters = gauss_seidel_solve(f, spec.h, target_error=0.0, max_iters=7)
    assert int(iters) == 7


def test_exact_solve_dispatch(small_problem):
    spec, f = small_problem
    u0 = exact_solve(f, spec.h, 1e-8, option=0)
    u1 = exact_solve(f, spec.h, 1e-10, option=1)
    u2 = exact_solve(f, spec.h, 1e-6, option=2)
    assert u2.dtype == f.dtype  # cast back from fp32
    np.testing.assert_allclose(np.asarray(u1), np.asarray(u0), atol=1e-7)
    np.testing.assert_allclose(np.asarray(u2), np.asarray(u0), atol=1e-3)
    with pytest.raises(ValueError):
        exact_solve(f, spec.h, 1e-8, option=9)


def test_analytic_is_discrete_solution_to_truncation_order():
    """residual(analytic) ≈ 0 at O(h²) — validates problem module consistency."""
    errs = []
    for n in (17, 33, 65):
        spec = GridSpec(n=n)
        f = REFERENCE_PROBLEM.source_grid(spec, dtype=jnp.float64)
        ua = REFERENCE_PROBLEM.analytic_grid(spec, dtype=jnp.float64)
        r = residual(ua, f, spec.h)
        errs.append(float(jnp.max(jnp.abs(r))))
    # truncation error shrinks ~4x per refinement
    assert errs[1] < 0.4 * errs[0]
    assert errs[2] < 0.4 * errs[1]
