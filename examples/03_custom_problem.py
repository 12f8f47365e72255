"""Custom Poisson problem + programmatic schedule (no Cycle.txt file).

The reference hardcodes one manufactured problem ("Problem Dependent",
reference README.md:272); here problems are pluggable objects and schedules
are first-class Python values.

    python examples/03_custom_problem.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax.numpy as jnp

import multigrid_poisson as mg
from multigrid_poisson.models.problems import Problem
from multigrid_poisson.solver import SolverConfig


def main():
    # u = sin(πx)·sinh(πy)/sinh(π): harmonic, nonzero Dirichlet boundary
    import math

    def boundary(x, y):
        return jnp.sin(math.pi * x) * jnp.sinh(math.pi * y) / math.sinh(math.pi)

    problem = Problem(source=lambda x, y: jnp.zeros_like(x),
                      boundary=boundary, analytic=boundary,
                      name="laplace-sinh")

    # W-cycle on an odd-halved (2:1-aligned) hierarchy with red-black GS
    # smoothing + full-weighting restriction — the fastest-converging combo
    program = mg.w_cycle(129, n_min=5, steps=2, coarse_option=0, coarsen=3)
    config = SolverConfig(smoother="rbgs", restriction="full_weighting")

    report = mg.solve(problem, program, config)
    print(f"W-cycle error vs analytic: {report.error_vs_analytic:.3e}")

    deep = mg.solve_to_tolerance(problem, 129, tol=1e-10, program=program,
                                 config=config)
    print(f"refined to {deep.rel_residual:.3e} in {deep.cycles} cycles; "
          f"error {deep.error_vs_analytic:.3e}")


if __name__ == "__main__":
    main()
