"""End-to-end smoke check of the solver on one GPU (or four, with an option).

    python chip_smoke.py                # one card: phases 1-7, then the JSON line
    python chip_smoke.py --four-cards   # four cards: the sharded phases only

One process drives every phase through the entry points a user calls (the
CLI's ``main``, ``compile_program``, ``compile_program3``, the refinement
solvers) at the sizes of BASELINE.json's configurations, and compares each
result with the repository's own reference: the interpreted engines (which
run the ``ops.stencils`` / ``models.poisson3d`` oracle ops), the reference
binary's recorded errors, the analytic solution, or the same program on one
card. Each phase prints one line: wall time (every timed call ends in
``block_until_ready``), compile time (set-up, outside the wall time),
``peak_bytes_in_use`` of device 0 (the process high-water mark so far), the
comparison with its tolerance, and PASS or FAIL.

The script exits non-zero, without its last line, if JAX finds no GPU or
any phase fails; an exception in a phase propagates. On success the last
line of stdout is one JSON object naming the device as JAX reports it.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SCHEDULES = ROOT / "schedules"
EXPECTED_CSV = ROOT / "tests" / "data" / "Sol_expected_test.txt"

# Final errors printed by the reference CPU binary on the bundled schedules
# (tests/test_reference_parity.py), compared with the CPU test's tolerance.
REFERENCE_ERRORS = {"test.txt": 0.000666, "Vcycle.txt": 0.000876,
                    "Wcycle.txt": 0.000050, "VcycleTrigger.txt": 0.000784}
REF_ABS, REF_REL = 2e-6, 1e-2

SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]


class PhaseFailed(Exception):
    pass


def parse_smi(text: str) -> list[tuple[str, str]]:
    """(name, power limit) per card from ``SMI_QUERY``'s CSV output."""
    cards = []
    for line in text.strip().splitlines():
        name, _, limit = line.rpartition(",")
        if not name:
            raise ValueError(f"unexpected nvidia-smi line {line!r}")
        cards.append((name.strip(), limit.strip()))
    return cards


def read_smi() -> str:
    """The card's name and power limit, read by a child that does not
    import JAX."""
    return subprocess.run(SMI_QUERY, capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()


def device_line(platform: str, kind: str, count: int) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def report(name: str, *, wall: float, compile_s, comparison: str,
           value: float, tol: float, ok: bool, note: str = "") -> dict:
    """Print one phase line and return it as a record."""
    comp = "n/a" if compile_s is None else f"{compile_s:.3f} s"
    line = (f"PHASE {name} | wall {wall:.6f} s | compile {comp} | "
            f"peak_bytes_in_use {_peak_bytes()} | {comparison} = {value:.6e}"
            f" (tol {tol:.1e}) | {'PASS' if ok else 'FAIL'}")
    print(line + (f" | {note}" if note else ""), flush=True)
    return {"name": name, "ok": ok}


def _compile(jitted, *args):
    t0 = time.perf_counter()
    exe = jitted.lower(*args).compile()
    return exe, time.perf_counter() - t0


def _run(exe, *args):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(exe(*args))
    return out, time.perf_counter() - t0


def _rel_max_diff(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


# --- phase 1 -------------------------------------------------------------------

def phase_device() -> tuple[str, str, int]:
    """Print the devices; exit non-zero unless JAX's platform is gpu."""
    import jax

    devs = jax.devices()
    d = devs[0]
    print(f"DEVICE {devs} | kind {d.device_kind} | count {len(devs)}",
          flush=True)
    if d.platform != "gpu":
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX found "
                         f"{d.platform!r}")
    smi = read_smi()
    for name, limit in parse_smi(smi):
        print(f"CARD {name} | power.limit {limit}", flush=True)
    print(smi, flush=True)
    return d.platform, d.device_kind, len(devs)


# --- phase 2 -------------------------------------------------------------------

def _cli(args: list[str]) -> tuple[str, float]:
    from multigrid_poisson import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise PhaseFailed(f"cli.main({args}) returned {rc}")
    return buf.getvalue(), wall


def _parse(out: str, key: str) -> float:
    m = re.findall(key + r"\s*=\s*([0-9.eE+-]+)", out)
    if not m:
        raise PhaseFailed(f"no {key!r} in CLI output:\n{out[-400:]}")
    return float(m[-1])


def compare_csv(got: str, want: str) -> tuple[bool, float, str]:
    """Byte-equal, or every value within one unit of the last printed
    digit (%.6f) where summation order tips a rounding."""
    if got == want:
        return True, 0.0, "byte-equal"
    g = [[float(x) for x in r.split(",") if x] for r in got.splitlines()]
    w = [[float(x) for x in r.split(",") if x] for r in want.splitlines()]
    if [len(r) for r in g] != [len(r) for r in w]:
        return False, float("inf"), "shape differs"
    diffs = [abs(a - b) for rg, rw in zip(g, w) for a, b in zip(rg, rw)]
    worst = max(diffs)
    n_diff = sum(d > 0 for d in diffs)
    ok = worst <= 1e-6 * (1 + 1e-9)
    return ok, worst, f"{n_diff} of {len(diffs)} values differ in the 6th decimal"


def phase_cli(schedules: Path = SCHEDULES,
              expected_csv: Path = EXPECTED_CSV) -> list[dict]:
    """The CLI in-process on the bundled schedules, compiled engine."""
    out = []
    for name, ref in REFERENCE_ERRORS.items():
        text, wall = _cli(["1", str(schedules / name), "--engine", "compiled",
                           "--quiet", "--no-output"])
        err = _parse(text, "Error")
        solve = _parse(text, "Time Used") / 1e3
        tol = max(REF_ABS, REF_REL * ref)
        out.append(report(
            f"cli {name}", wall=solve, compile_s=wall - solve,
            comparison=f"|Error - reference {ref}|", value=abs(err - ref),
            tol=tol, ok=abs(err - ref) <= tol,
            note=f"Error {err:.6e}; compile = CLI call minus Time Used"))
    with tempfile.TemporaryDirectory() as tmp:
        csv = Path(tmp) / "Sol_test.csv"
        text, wall = _cli(["1", str(schedules / "test.txt"), "--dtype", "f64",
                           "--engine", "compiled", "--quiet",
                           "--output", str(csv)])
        ok, worst, how = compare_csv(csv.read_text(),
                                     expected_csv.read_text())
    solve = _parse(text, "Time Used") / 1e3
    out.append(report("cli test.txt f64 csv", wall=solve,
                      compile_s=wall - solve,
                      comparison="max |csv - Sol_expected_test.txt|",
                      value=worst, tol=1e-6, ok=ok, note=how))
    return out


# --- phase 3 -------------------------------------------------------------------

def _agreement(program, dtype, cycles: int) -> float:
    """max|Δu|/max|u| between the compiled engine and the interpreted one
    (the ``ops.stencils`` oracle ops) after ``cycles`` chained cycles."""
    import multigrid_poisson as mg

    cfg = mg.SolverConfig(omega=0.8, collect_node_stats=False, dtype=dtype)
    cc = mg.compile_program(program, mg.REFERENCE_PROBLEM, cfg, donate=False)
    u, f = cc.init()
    got = cc.unpad(cc.iterate(cycles)(u, f))
    ref = mg.MultigridSolver(mg.REFERENCE_PROBLEM, cfg).run(
        mg.repeat(program, cycles))
    return _rel_max_diff(got, ref.u)


def phase_vcycle(n: int = 4097, cycles: int = 20, check_cycles: int = 3,
                 smooth_n: int = 8193, smooth_sweeps: int = 50,
                 tol: float = 1e-5) -> list[dict]:
    """Compiled V(3,3), ω=0.8, cold + warm chained and timed in fp32;
    agreement with the interpreted engine; compensated residual after 1
    and 6 cycles; the plain XLA smoother's time per sweep at ``smooth_n``.

    In fp32 the two engines agree only until their iterates reach the fp32
    floor, where the residual's cancellation noise (≈ eps·|u|/h², O(0.1)
    relative at N ≥ 2049) drives each one differently: after one cycle they
    agree to rounding, after two they differ by that noise (3e-4 at N=2049
    on CPU). So fp32 is compared after one cycle and the ``check_cycles``
    comparison runs in float64, where only the operators can differ."""
    import jax
    import jax.numpy as jnp

    import multigrid_poisson as mg
    from multigrid_poisson.ops import layout, stencils
    from multigrid_poisson.ops import padded as P

    cfg = mg.SolverConfig(omega=0.8, collect_node_stats=False)
    program = mg.v_cycle(n, n_min=8, steps=3, coarse_option=0, coarsen=3)
    cc = mg.compile_program(program, mg.REFERENCE_PROBLEM, cfg, donate=False)
    u, f = cc.init()
    exe, comp = _compile(cc.iterate(cycles), u, f)
    _, wall = _run(exe, u, f)
    d32 = _agreement(program, jnp.float32, 1)
    d64 = _agreement(program, jnp.float64, check_cycles)
    h = cc.finest_spec.h
    r1 = float(P.relative_residual_norm_p(cc.iterate(1)(u, f), f, h, n))
    r6 = float(P.relative_residual_norm_p(cc.iterate(6)(u, f), f, h, n))
    out = [report(f"vcycle2d N={n} x{cycles}", wall=wall, compile_s=comp,
                  comparison="max|du|/max|u| vs interpreted, fp32 1 cycle",
                  value=d32, tol=tol, ok=d32 <= tol and d64 <= tol,
                  note=f"f64 {check_cycles} cycles {d64:.3e} (tol "
                       f"{tol:.0e}); {wall / cycles * 1e3:.4f} ms/cycle; "
                       f"compensated rel residual {r1:.3e} after 1 cycle, "
                       f"{r6:.3e} after 6")]

    spec = mg.GridSpec(smooth_n)
    prob = mg.REFERENCE_PROBLEM
    fs = layout.pad_grid(prob.source_grid(spec, jnp.float32)
                         + prob.boundary_grid(spec, jnp.float32))
    us = layout.pad_grid(prob.boundary_grid(spec, jnp.float32))
    sweep = jax.jit(lambda v, g: jax.lax.fori_loop(
        0, smooth_sweeps,
        lambda _, w: P.jacobi_sweep_p(w, g, spec.h, smooth_n), v))
    exe, comp = _compile(sweep, us, fs)
    got, wall = _run(exe, us, fs)
    two = jax.jit(lambda v, g: jax.lax.fori_loop(
        0, 2, lambda _, w: P.jacobi_sweep_p(w, g, spec.h, smooth_n), v))
    ug = layout.unpad_grid(us, smooth_n)
    fg = layout.unpad_grid(fs, smooth_n)
    want, _ = stencils.smooth(ug, fg, spec.h, steps=2)
    d = _rel_max_diff(layout.unpad_grid(two(us, fs), smooth_n), want)
    out.append(report(
        f"smoother N={smooth_n} x{smooth_sweeps}", wall=wall, compile_s=comp,
        comparison="max|du|/max|u| vs ops.stencils (2 sweeps)",
        value=d, tol=tol, ok=d <= tol and bool(jnp.isfinite(got).all()),
        note=f"{wall / smooth_sweeps * 1e3:.4f} ms/sweep"))
    return out


# --- phase 4 -------------------------------------------------------------------

def phase_trigger(n: int = 1025, tol: float = 1e-3) -> list[dict]:
    """Trigger W-cycle (BASELINE config 2): the device-side while_loop
    trigger and the coarse Gauss-Seidel loop, against the interpreted
    engine (which reports the trigger sweep counts; the compiled engine
    keeps them on the device and reports none)."""
    import jax.numpy as jnp

    import multigrid_poisson as mg
    from multigrid_poisson.ops import stencils

    cfg = mg.SolverConfig(omega=0.8, collect_node_stats=False)
    program = mg.w_cycle(n, n_min=8, steps=-1, coarse_option=0)
    cc = mg.compile_program(program, mg.REFERENCE_PROBLEM, cfg, donate=False)
    u, f = cc.init()
    exe, comp = _compile(cc.fn, u, f)
    (u1, _), wall = _run(exe, u, f)
    ua = mg.REFERENCE_PROBLEM.analytic_grid(cc.finest_spec, jnp.float32)
    err = float(stencils.mean_abs_error(cc.unpad(u1), ua))
    icfg = mg.SolverConfig(omega=0.8, collect_node_stats=True)
    rep = mg.MultigridSolver(mg.REFERENCE_PROBLEM, icfg).run(program)
    sweeps = [nd.steps for nd in rep.nodes
              if nd.kind in ("descend", "ascend") and nd.steps]
    d = abs(err - rep.error_vs_analytic) / rep.error_vs_analytic
    return [report(f"trigger wcycle N={n}", wall=wall, compile_s=comp,
                   comparison="|err - interpreted err|/err", value=d,
                   tol=tol, ok=d <= tol,
                   note=f"error {err:.6e}; interpreted engine: "
                        f"{sum(sweeps)} trigger sweeps over {len(sweeps)} "
                        f"smoothing nodes, at most {max(sweeps)} per node")]


# --- phase 5 -------------------------------------------------------------------

def phase_fmg(n: int = 4097, tol: float = 1e-5) -> list[dict]:
    """FMG (BASELINE config 3) through compile_program, timed in fp32, and
    its error against the analytic solution beside the discretization
    floor — the error of the converged discrete solution (tw32 refinement
    to 1e-12). One FMG pass of this schedule does not reach that floor: it
    ends with interpolation and post-smoothing on the finest level, and in
    fp32 the residual noise grows the error with N. So the pass criterion
    is agreement with the interpreted engine (float64, where only the
    operators can differ), and the errors are readings."""
    import jax.numpy as jnp

    import multigrid_poisson as mg
    from multigrid_poisson.ops import stencils

    cfg = mg.SolverConfig(omega=0.8, collect_node_stats=False)
    program = mg.fmg(n, n_min=8, steps=3, coarse_option=0, coarsen=3)
    cc = mg.compile_program(program, mg.REFERENCE_PROBLEM, cfg, donate=False)
    u, f = cc.init()
    exe, comp = _compile(cc.fn, u, f)
    (u1, _), wall = _run(exe, u, f)
    ua = mg.REFERENCE_PROBLEM.analytic_grid(cc.finest_spec, jnp.float32)
    err32 = float(stencils.mean_abs_error(cc.unpad(u1), ua))

    cfg64 = mg.SolverConfig(omega=0.8, collect_node_stats=False,
                            dtype=jnp.float64)
    cc64 = mg.compile_program(program, mg.REFERENCE_PROBLEM, cfg64,
                              donate=False)
    got = cc64.unpad(cc64(*cc64.init())[0])
    ref = mg.MultigridSolver(mg.REFERENCE_PROBLEM, cfg64).run(program)
    d = _rel_max_diff(got, ref.u)
    floor = mg.solve_to_tolerance(mg.REFERENCE_PROBLEM, n, tol=1e-12,
                                  state="tw32").error_vs_analytic
    return [report(f"fmg N={n}", wall=wall, compile_s=comp,
                   comparison="max|du|/max|u| vs interpreted, f64",
                   value=d, tol=tol, ok=d <= tol,
                   note=f"mean|u - analytic| fp32 {err32:.3e}, f64 "
                        f"{ref.error_vs_analytic:.3e}; discretization "
                        f"floor {floor:.3e}")]


# --- phase 6 -------------------------------------------------------------------

def _deep(n: int, state: str, tol: float, max_cycles: int):
    import jax.numpy as jnp

    import multigrid_poisson as mg
    from multigrid_poisson.refine import (IterativeRefinementSolver,
                                          relative_residual_f64)

    s = IterativeRefinementSolver(mg.REFERENCE_PROBLEM, n, state=state,
                                  max_cycles=max_cycles)
    f = s.init_rhs()
    u0, u1 = s.initial_state()
    if state == "f64":
        args = (u0.astype(jnp.float64), f, tol, max_cycles)
    else:
        args = (u0, u1, jnp.zeros_like(u0), f, tol, max_cycles)
    exe, comp = _compile(s._run, *args)
    res, wall = _run(exe, *args)
    words = res[:1] if state == "f64" else res[:3]
    rel = float(relative_residual_f64(words, f, s.spec.h, n))
    return rel, int(res[-1]), wall, comp


def phase_deep(n: int = 8193, f64_n: int = 2049, tol: float = 1e-10,
               max_cycles: int = 40) -> list[dict]:
    """Solve to 1e-10 with the tw32 and the f64 state; every relative
    residual is recomputed in float64 (compensated) on the device.

    An f64 state cannot reach 1e-10 at N=8193: rounding the solution to
    float64 alone leaves a residual of ≈ eps64·‖A‖‖u‖/‖f‖, which grows as
    N² (7e-11 at N=2049 measured on CPU, ×4 per doubling). So f64 is held
    to ``tol`` at ``f64_n`` and its floor at ``n`` is printed as a reading,
    not as a pass criterion."""
    out = []
    rel, k, wall, comp = _deep(n, "tw32", tol, max_cycles)
    out.append(report(f"deep tw32 N={n}", wall=wall, compile_s=comp,
                      comparison="f64 rel residual", value=rel, tol=tol,
                      ok=rel <= tol, note=f"{k} cycles"))
    rel, k, wall, comp = _deep(f64_n, "f64", tol, max_cycles)
    out.append(report(f"deep f64 N={f64_n}", wall=wall, compile_s=comp,
                      comparison="f64 rel residual", value=rel, tol=tol,
                      ok=rel <= tol, note=f"{k} cycles"))
    if n != f64_n:
        rel, k, wall, comp = _deep(n, "f64", tol, max_cycles)
        print(f"READING deep f64 N={n} | wall {wall:.6f} s | compile "
              f"{comp:.3f} s | peak_bytes_in_use {_peak_bytes()} | f64 rel "
              f"residual {rel:.6e} after {k} cycles (f64 state floor; no "
              f"pass criterion)", flush=True)
    return out


# --- phase 7 -------------------------------------------------------------------

def _cycles3(cc, cycles: int):
    import jax

    return jax.jit(lambda u, f: jax.lax.fori_loop(
        0, cycles - 1, lambda i, v: cc._fn_warm(v, f)[0], cc._fn(u, f)[0]))


def phase_3d(n: int = 513, check_n: int = 129, cycles: int = 4,
             deep_tol: float = 1e-10, tol: float = 1e-5) -> list[dict]:
    """compile_program3 V(3,3) at ``n`` (timed) and at ``check_n`` against
    the interpreted Solver3D; then the tw32 solve to ``deep_tol`` with its
    residual recomputed in float64."""
    import multigrid_poisson as mg
    from multigrid_poisson.models import poisson3d as p3
    from multigrid_poisson.refine3 import (IterativeRefinement3,
                                           relative_residual3_f64)

    cfg = mg.SolverConfig(omega=6.0 / 7.0, collect_node_stats=False)
    prob = p3.REFERENCE_PROBLEM_3D

    def program(m):
        return mg.v_cycle(m, n_min=5, steps=3, coarse_option=0, coarsen=3)

    cc = mg.compile_program3(program(n), prob, cfg)
    u, f = cc.init()
    exe, comp = _compile(_cycles3(cc, cycles), u, f)
    got, wall = _run(exe, u, f)
    small = mg.compile_program3(program(check_n), prob, cfg)
    us, fs = small.init()
    got_s = _cycles3(small, cycles)(us, fs)
    ref = mg.Solver3D(prob, cfg).run(mg.repeat(program(check_n), cycles))
    d = _rel_max_diff(got_s, ref.u)
    out = [report(f"3d vcycle N={n}^3 x{cycles}", wall=wall, compile_s=comp,
                  comparison=f"max|du|/max|u| vs Solver3D at {check_n}^3",
                  value=d, tol=tol, ok=d <= tol,
                  note=f"{wall / cycles * 1e3:.4f} ms/cycle")]

    s = IterativeRefinement3(prob, n, max_cycles=40, state="tw32")
    f3 = s.init_rhs()
    w0, w1 = s.initial_state()
    import jax.numpy as jnp

    args = (w0, w1, jnp.zeros_like(w0), f3, deep_tol, 40)
    exe, comp = _compile(s._run, *args)
    res, wall = _run(exe, *args)
    rel = float(relative_residual3_f64(res[:3], f3, s.h))
    out.append(report(f"3d deep tw32 N={n}^3", wall=wall, compile_s=comp,
                      comparison="f64 rel residual", value=rel,
                      tol=deep_tol, ok=rel <= deep_tol,
                      note=f"{int(res[-1])} cycles"))
    return out


# --- four cards ---------------------------------------------------------------

def phase_four_cards(n2: int = 8193, n_fmg: int = 4097, n3: int = 513,
                     halo_sweeps: int = 10, tol: float = 1e-6,
                     devices=None) -> list[dict]:
    """Each sharded path against the same program on one device: rows
    (ShardingPolicy) V(3,3), 2×2 blocks (BlockShardingPolicy) FMG, 3-D
    z-planes (ZShardingPolicy3) V(3,3), and parallel.halo.sharded_smooth."""
    import jax
    import jax.numpy as jnp

    import multigrid_poisson as mg
    from multigrid_poisson.models import poisson3d as p3
    from multigrid_poisson.ops import stencils
    from multigrid_poisson.parallel import halo
    from multigrid_poisson.parallel.mesh import (
        BlockShardingPolicy, ShardingPolicy, ZShardingPolicy3, make_mesh,
        make_mesh_2d, make_mesh_z, pad_rows, row_sharding, unpad_rows)

    devices = list(devices or jax.devices())
    ndev = len(devices)
    cfg = mg.SolverConfig(omega=0.8, collect_node_stats=False)
    out = []

    def one_vs_many(name, program, policy, mesh):
        cc1 = mg.compile_program(program, mg.REFERENCE_PROBLEM, cfg,
                                 donate=False)
        u, f = cc1.init()
        want = cc1.unpad(cc1(u, f)[0])
        with mesh:
            ccp = mg.compile_program(program, mg.REFERENCE_PROBLEM, cfg,
                                     policy=policy, donate=False)
            up, fp = ccp.init()
            exe, comp = _compile(ccp.fn, up, fp)
            (got, _), wall = _run(exe, up, fp)
        d = _rel_max_diff(ccp.unpad(got), want)
        return report(name, wall=wall, compile_s=comp,
                      comparison="max|du|/max|u| vs one device", value=d,
                      tol=tol, ok=d <= tol)

    rows = make_mesh(devices)
    out.append(one_vs_many(
        f"rows x{ndev} vcycle N={n2}",
        mg.v_cycle(n2, n_min=8, steps=3, coarse_option=0, coarsen=3),
        ShardingPolicy(rows), rows))
    side = int(round(ndev ** 0.5))
    blocks = make_mesh_2d((side, ndev // side), devices)
    out.append(one_vs_many(
        f"blocks {side}x{ndev // side} fmg N={n_fmg}",
        mg.fmg(n_fmg, n_min=8, steps=3, coarse_option=0, coarsen=3),
        BlockShardingPolicy(blocks), blocks))

    cfg3 = mg.SolverConfig(omega=6.0 / 7.0, collect_node_stats=False)
    prob3 = p3.REFERENCE_PROBLEM_3D
    program3 = mg.v_cycle(n3, n_min=5, steps=3, coarse_option=0, coarsen=3)
    cc1 = mg.compile_program3(program3, prob3, cfg3)
    u, f = cc1.init()
    want = cc1(u, f)[0]
    zmesh = make_mesh_z(devices)
    with zmesh:
        ccz = mg.compile_program3(program3, prob3, cfg3,
                                  policy=ZShardingPolicy3(zmesh))
        exe, comp = _compile(ccz._fn, u, f)
        (got, _), wall = _run(exe, u, f)
    d = _rel_max_diff(got, want)
    out.append(report(f"z-planes x{ndev} 3d vcycle N={n3}^3", wall=wall,
                      compile_s=comp, comparison="max|du|/max|u| vs one "
                      "device", value=d, tol=tol, ok=d <= tol))

    h = 1.0 / (n2 - 1)
    spec = mg.GridSpec(n2)
    prob = mg.REFERENCE_PROBLEM
    fg = prob.source_grid(spec, jnp.float32) + prob.boundary_grid(
        spec, jnp.float32)
    ug = prob.boundary_grid(spec, jnp.float32)
    want, _ = stencils.smooth(ug, fg, h, steps=halo_sweeps)
    sh = row_sharding(rows)
    us = jax.device_put(pad_rows(ug, ndev), sh)
    fs = jax.device_put(pad_rows(fg, ndev), sh)
    smooth = jax.jit(lambda a, b: halo.sharded_smooth(a, b, h, halo_sweeps,
                                                      rows))
    exe, comp = _compile(smooth, us, fs)
    got, wall = _run(exe, us, fs)
    d = _rel_max_diff(unpad_rows(got, n2), want)
    out.append(report(f"halo sharded_smooth x{ndev} N={n2}", wall=wall,
                      compile_s=comp, comparison="max|du|/max|u| vs one "
                      "device", value=d, tol=tol, ok=d <= tol,
                      note=f"{halo_sweeps} sweeps"))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded phases on four cards")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)   # the f64 phases and checks
    from multigrid_poisson.utils.compile_cache import enable_compile_cache

    platform, kind, count = phase_device()
    enable_compile_cache()
    if args.four_cards:
        if count != 4:
            raise SystemExit(f"--four-cards needs 4 devices, found {count}")
        results = phase_four_cards()
    else:
        results = (phase_cli() + phase_vcycle() + phase_trigger()
                   + phase_fmg() + phase_deep() + phase_3d())
    failed = [r["name"] for r in results if not r["ok"]]
    if failed:
        print(f"FAILED phases: {failed}", file=sys.stderr)
        return 1
    print(device_line(platform, kind, count))
    return 0


if __name__ == "__main__":
    sys.exit(main())
