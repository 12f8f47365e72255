"""Benchmark driver: smoothing throughput plus cycle and deep-solve times.

Prints ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": "GDoF/s", "vs_baseline": N}

``value`` is smoothed interior cells per second for fp32 Jacobi sweeps at
N=8193 (BASELINE.json config 4's grid, one card), on the engine's hot path
(``ops.padded.jacobi_sweep_p``, one sweep per pass, left to XLA).
``vs_baseline`` is that rate over the card's memory-bandwidth bound for one
sweep (read u and f, write u: 12 bytes/point in fp32), with the bandwidth
taken from the published table in ``utils.profiling``.

Context on stderr, at the BASELINE.json sizes: a converging V(3,3) cycle at
4097² with its residual contraction, the trigger W-cycle at 1025² (config
2), FMG at 4097² (config 3), the 2-D solve to 1e-10 at 8193², and the 3-D
V(3,3) cycle and solve to 1e-10 at 513³.

Every time is a median over repeated calls that each end in
``block_until_ready``, after a warm-up call that compiles. The script needs
a GPU and a device kind the bandwidth table knows; it exits with an error
otherwise. Run it as one process per card.
"""

from __future__ import annotations

import json
import subprocess
import sys

import jax
import jax.numpy as jnp

import multigrid_poisson as mg
from multigrid_poisson.ops import layout
from multigrid_poisson.ops import padded as P
from multigrid_poisson.utils.compile_cache import enable_compile_cache
from multigrid_poisson.utils.profiling import hbm_bandwidth, time_call


def _log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def bench_smoothing(n: int, sweeps: int):
    """(GDoF/s, s/sweep) of fp32 Jacobi sweeps on the padded layout."""
    spec = mg.GridSpec(n)
    prob = mg.REFERENCE_PROBLEM
    f = layout.pad_grid(prob.source_grid(spec, jnp.float32)
                        + prob.boundary_grid(spec, jnp.float32))
    u = layout.pad_grid(prob.boundary_grid(spec, jnp.float32))
    run = jax.jit(lambda u, f: jax.lax.fori_loop(
        0, sweeps, lambda _, v: P.jacobi_sweep_p(v, f, spec.h, n), u))
    t, _, _ = time_call(run, u, f)
    per_sweep = t / sweeps
    return (n - 2) ** 2 / per_sweep / 1e9, per_sweep


def bench_vcycle(n: int, cycles: int = 20):
    """s/cycle of the converging V(3,3), ω=0.8 cycle and the compensated
    relative residual after 1 and 6 cycles."""
    cfg = mg.SolverConfig(omega=0.8, collect_node_stats=False)
    program = mg.v_cycle(n, n_min=8, steps=3, coarse_option=0, coarsen=3)
    cc = mg.compile_program(program, mg.REFERENCE_PROBLEM, cfg, donate=False)
    u, f = cc.init()
    t, _, _ = time_call(cc.iterate(cycles), u, f)
    h = cc.finest_spec.h

    def rel_after(k):
        uk = cc.iterate(k)(u, f)
        return float(P.relative_residual_norm_p(uk, f, h, n))

    return t / cycles, rel_after(1), rel_after(6)


def bench_program(program, cfg, cycles: int):
    """s/cycle of ``program`` chained ``cycles`` times."""
    cc = mg.compile_program(program, mg.REFERENCE_PROBLEM, cfg, donate=False)
    u, f = cc.init()
    t, _, _ = time_call(cc.iterate(cycles), u, f)
    return t / cycles


def bench_deep(n: int, tol: float = 1e-10, max_cycles: int = 30):
    """Device wall time to ``tol`` via tw32 refinement (one jitted loop)."""
    from multigrid_poisson.refine import IterativeRefinementSolver

    s = IterativeRefinementSolver(mg.REFERENCE_PROBLEM, n, state="tw32",
                                  max_cycles=max_cycles)
    f = s.init_rhs()
    u0, u1 = s.initial_state()
    args = (u0, u1, jnp.zeros_like(u0), f, tol, max_cycles)
    t, _, _ = time_call(s._run, *args, reps=3)
    *_, rel, k = s._run(*args)
    return t, float(rel), int(k)


def bench_3d(n: int, cycles: int = 4):
    from multigrid_poisson.models import poisson3d as p3

    cfg = mg.SolverConfig(omega=6.0 / 7.0, collect_node_stats=False)
    program = mg.v_cycle(n, n_min=5, steps=3, coarse_option=0, coarsen=3)
    cc = mg.compile_program3(program, p3.REFERENCE_PROBLEM_3D, cfg)
    u, f = cc.init()
    run = jax.jit(lambda u, f: jax.lax.fori_loop(
        0, cycles - 1, lambda i, v: cc._fn_warm(v, f)[0], cc._fn(u, f)[0]))
    t, _, _ = time_call(run, u, f, reps=3)
    return t / cycles


def bench_3d_deep(n: int, tol: float = 1e-10, max_cycles: int = 25):
    from multigrid_poisson.models import poisson3d as p3
    from multigrid_poisson.refine3 import IterativeRefinement3

    s = IterativeRefinement3(p3.REFERENCE_PROBLEM_3D, n,
                             max_cycles=max_cycles, state="tw32")
    f = s.init_rhs()
    w0, w1 = s.initial_state()
    args = (w0, w1, jnp.zeros_like(w0), f, tol, max_cycles)
    t, _, _ = time_call(s._run, *args, reps=3)
    *_, rel, k = s._run(*args)
    return t, float(rel), int(k)


def main() -> int:
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 1
    bw = hbm_bandwidth(dev.device_kind)
    enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    _log(f"device={dev.device_kind} platform={dev.platform} "
         f"count={len(jax.devices())}; nvidia-smi: {smi.strip()}")

    n, sweeps = 8193, 50
    gdofs, per_sweep = bench_smoothing(n, sweeps)
    bound = bw / 12.0 / 1e9
    _log(f"smoothing N={n}: {gdofs:.2f} GDoF/s ({per_sweep * 1e3:.4f} "
         f"ms/sweep); memory-bandwidth bound {bound:.1f} GDoF/s at "
         f"{bw / 1e12:.2f} TB/s")

    dt, r1, r6 = bench_vcycle(4097)
    _log(f"V(3,3) w=0.8 N=4097: {dt * 1e3:.3f} ms/cycle; compensated rel "
         f"residual {r1:.3e} after 1 cycle, {r6:.3e} after 6")

    cfg = mg.SolverConfig(omega=0.8, collect_node_stats=False)
    tw = bench_program(mg.w_cycle(1025, n_min=8, steps=-1, coarse_option=0),
                       cfg, 20)
    _log(f"trigger W-cycle N=1025: {tw * 1e3:.3f} ms/cycle")

    tf = bench_program(mg.fmg(4097, n_min=8, steps=3, coarse_option=0,
                              coarsen=3), cfg, 1)
    _log(f"FMG N=4097: {tf * 1e3:.3f} ms")

    t10, rel, k = bench_deep(8193)
    _log(f"to 1e-10 N=8193 (tw32): {t10 * 1e3:.1f} ms, {k} cycles, "
         f"rel residual {rel:.3e}")

    t3 = bench_3d(513)
    _log(f"3-D V(3,3) 513^3: {t3 * 1e3:.2f} ms/cycle")

    t3d, rel3, k3 = bench_3d_deep(513)
    _log(f"3-D to 1e-10 513^3 (tw32): {t3d * 1e3:.1f} ms, {k3} cycles, "
         f"rel residual {rel3:.3e}")

    print(json.dumps({
        "metric": f"fp32 Jacobi smoothing throughput, N={n}, "
                  f"1 {dev.device_kind}",
        "value": round(gdofs, 3),
        "unit": "GDoF/s",
        "vs_baseline": round(gdofs / bound, 4),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
