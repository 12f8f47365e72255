"""Characterize the tw32 refinement floor vs N (ROADMAP r3 item 5).

Runs tw32 (triple-word fp32) iterative refinement to stagnation on CPU for
a ladder of sizes and fits the floor's power law in N. The floor is set by
the residual *evaluation* (dd-EFT compensated), not the state: the state
carries ~2^-72 while the measured floors sit far above it and grow with N.
"""
import sys
import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")

import multigrid_poisson as mg
from multigrid_poisson.refine import IterativeRefinementSolver

sizes = [int(s) for s in (sys.argv[1:] or ["257", "513", "1025", "2049"])]
rows = []
for n in sizes:
    s = IterativeRefinementSolver(mg.REFERENCE_PROBLEM, n, state="tw32",
                                  max_cycles=25)
    f = s.init_rhs()
    u0, u1 = s.initial_state()
    u2 = jax.numpy.zeros_like(u0)
    out = s._run(u0, u1, u2, f, 0.0, 25)
    rel, k = float(jax.device_get(out[3])), int(jax.device_get(out[4]))
    rows.append((n, rel, k))
    print(f"N={n:5d}: floor rel residual {rel:.3e} after {k} cycles",
          flush=True)

if len(rows) >= 3:
    ns = np.log([r[0] - 1 for r in rows])
    fs = np.log([r[1] for r in rows])
    slope, icept = np.polyfit(ns, fs, 1)
    print(f"\npower-law fit: floor ~ (N-1)^{slope:.2f} "
          f"(coef {np.exp(icept):.3e})")
