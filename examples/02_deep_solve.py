"""Deep convergence: solve to 1e-10 relative residual in fp32 arithmetic.

The reference's fp64 host arrays get ~1e-15 floors for free; here the fast
path is fp32, so the framework uses double-float iterative refinement
(refine.py) — fp32 V-cycles inside, two-word fp32 state outside.

    python examples/02_deep_solve.py [n]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import sys

import multigrid_poisson as mg


def main(n=257):
    n = int(n)
    report = mg.solve_to_tolerance(mg.REFERENCE_PROBLEM, n, tol=1e-10)
    print(f"N={n}: rel residual {report.rel_residual:.3e} "
          f"after {report.cycles} refinement cycles "
          f"({report.wall_time_s:.2f}s)")
    print(f"error vs analytic: {report.error_vs_analytic:.3e} "
          "(discretization floor)")

    # below the df32 floor: triple-word fp32 state (inner cycles stay fp32;
    # reaches 1e-10 at N=8193 and ~1e-14 at small N)
    deep = mg.solve_to_tolerance(mg.REFERENCE_PROBLEM, n, tol=1e-13,
                                 state="tw32", max_cycles=30)
    print(f"tw32 state: rel residual {deep.rel_residual:.3e} "
          f"after {deep.cycles} cycles")


if __name__ == "__main__":
    main(*sys.argv[1:])
