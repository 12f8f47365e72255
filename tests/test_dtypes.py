"""Dtype-policy coverage: the solver runs in bfloat16 and float64 too.

fp32 is the default; bf16 halves memory/bandwidth at an accuracy ceiling of
~eps_bf16·‖u‖ (mean-abs error ~1e-3-class on the reference problem — useful
as a preconditioner/initializer, not for tight tolerances); f64 is native on
CPUs and GPUs.
"""

import jax.numpy as jnp
import pytest

import multigrid_poisson as mg
from multigrid_poisson.solver import SolverConfig

PROBLEM = mg.REFERENCE_PROBLEM
PROG = mg.v_cycle(65, n_min=8, steps=3, coarse_option=0)


@pytest.mark.parametrize("dtype,ceiling", [
    # one V(3,3) cycle leaves ~8.5e-4 iteration error in every dtype;
    # bf16's representation ceiling happens to sit at the same scale here
    (jnp.bfloat16, 5e-3),
    (jnp.float32, 2e-3),
    (jnp.float64, 2e-3),
])
def test_both_engines_converge_per_dtype(dtype, ceiling):
    cfg = SolverConfig(dtype=dtype)
    rep = mg.solve(PROBLEM, PROG, cfg)
    assert rep.error_vs_analytic < ceiling

    cc = mg.compile_program(PROG, PROBLEM, cfg, donate=False)
    u, f = cc.init()
    u1, _ = cc(u, f)
    from multigrid_poisson.ops.stencils import mean_abs_error

    ua = PROBLEM.analytic_grid(cc.finest_spec, jnp.float32)
    err = float(mean_abs_error(cc.unpad(u1).astype(jnp.float32), ua))
    assert err < ceiling


def test_bf16_chaining_floors_far_above_fp32():
    """Chained bf16 cycles do NOT keep converging — corrections fall below
    bf16 resolution and iteration noise accumulates (measured: ~1e-2 after
    4 cycles vs fp32's ~6e-6). Documents that bf16 is a single-pass /
    preconditioner mode, not a deep-solve mode."""
    cfg = SolverConfig(dtype=jnp.bfloat16)
    rep = mg.solve(PROBLEM, mg.repeat(PROG, 4), cfg)
    assert rep.error_vs_analytic < 5e-2        # bounded, not divergent

    rep32 = mg.solve(PROBLEM, mg.repeat(PROG, 4), SolverConfig())
    assert rep32.error_vs_analytic < rep.error_vs_analytic / 10
