"""3-D schedule engine: executes a CycleProgram on a cubic hierarchy.

The schedule grammar (Cycle.txt, schedule.py) is dimension-agnostic — N
values name level sizes, Descend/Ascend/CoarseSolve have the same meaning —
so the same parsed programs drive this 3-D engine unchanged. Node semantics
mirror solver.MultigridSolver one dimension up (reference scheduler loop:
MG_solver_CPU.cpp:158-426):

  * Descend: (re-zero correction unless warm finest / FMG) → smooth →
    restrict the negated residual via the general trilinear zoom3.
  * CoarseSolve: option 0 dense cached-inverse solve, options 1/2 red-black
    GS to target (fp64 under x64 for option 1, fp32 for option 2).
  * Ascend: zoom3-prolongate + add into the parent interior → post-smooth.
  * steps == -1 trigger smoothing runs device-side (lax.while_loop).

Metric note: the 2-D CPU reference's color-bugged trigger metric is
2-D-specific; compat=True maps to the clean mean-|residual| metric here
(compat="gpu" keeps its 3-D analog |ΔU|·6/h²). Everything else in
SolverConfig (smoother, omega, dtype, trigger, restriction) applies as in
2-D; restriction="full_weighting" requires 2:1-aligned levels exactly as the
2-D engine does.
"""

from __future__ import annotations

import time
from functools import partial

import jax
import jax.numpy as jnp

from .grid import GridSpec
from .models import poisson3d as p3
from .models.poisson3d import Problem3D
from .ops.zoom import zoom3
from .schedule import Ascend, CoarseSolve, CycleProgram, Descend
from .solver import Level, NodeReport, SolveReport, SolverConfig, logger


@partial(jax.jit, static_argnames=("h", "m", "restriction"))
def _restrict_residual3(u, f, h: float, m: int, restriction: str = "sampling"):
    """residual → negate → restriction → zero boundary, one compiled graph
    (3-D analog of solver._restrict_residual_fused)."""
    d = p3.residual3(u, f, h)
    n = u.shape[0]
    if restriction == "full_weighting":
        if n != 2 * m - 1:
            raise ValueError(
                f"restriction='full_weighting' requires 2:1 vertex-aligned "
                f"levels (n == 2m-1), got {n} -> {m}")
        return p3.restrict3(-d, m)
    return zoom3(-d, m, zero_boundary=True)


@partial(jax.jit, static_argnames=("n",))
def _prolong_add3(u_coarse, u_fine, n: int):
    corr = zoom3(u_coarse, n)
    return u_fine.at[1:-1, 1:-1, 1:-1].add(corr[1:-1, 1:-1, 1:-1])


class Solver3D:
    """Executes CyclePrograms on 3-D problems under a SolverConfig."""

    def __init__(self, problem: Problem3D, config: SolverConfig = SolverConfig()):
        self.problem = problem
        self.config = config

    def _finest_level(self, program: CycleProgram) -> Level:
        spec = GridSpec(program.n_max, program.length, program.min_x,
                        program.min_y)
        dtype = self.config.dtype
        f = (self.problem.source_grid(spec.n, dtype)
             + self.problem.boundary_grid(spec.n, dtype))
        u = self.problem.boundary_grid(spec.n, dtype)
        return Level(spec=spec, u=u, f=f)

    def _reset_u(self, level: Level, finest: bool) -> jnp.ndarray:
        if finest:
            return self.problem.boundary_grid(level.spec.n, self.config.dtype)
        return jnp.zeros((level.spec.n,) * 3, self.config.dtype)

    def run(self, program: CycleProgram) -> SolveReport:
        cfg = self.config
        levels: list[Level] = [self._finest_level(program)]
        warm = False
        nodes: list[NodeReport] = []

        start = time.perf_counter()
        for ins in program.instructions:
            lvl = levels[-1]
            n, h = lvl.spec.n, lvl.spec.h

            if isinstance(ins, Descend):
                finest = len(levels) == 1
                if not (finest and warm) and not lvl.is_fmg:
                    lvl.u = self._reset_u(lvl, finest)

                if ins.steps == 0:  # FMG descent: restrict the RHS itself
                    next_spec = lvl.spec.coarsened(ins.next_n)
                    f_c = zoom3(lvl.f, ins.next_n, zero_boundary=True)
                    f_c = f_c + self.problem.boundary_grid(next_spec.n, cfg.dtype)
                    levels.append(Level(spec=next_spec,
                                        u=jnp.zeros((next_spec.n,) * 3, cfg.dtype),
                                        f=f_c, is_fmg=True))
                    nodes.append(NodeReport("fmg-descend", n, steps=0))
                    continue

                lvl.u, err, taken = self._smooth(lvl, ins.steps)
                f_c = _restrict_residual3(lvl.u, lvl.f, h, ins.next_n,
                                          restriction=cfg.restriction)
                next_spec = lvl.spec.coarsened(ins.next_n)
                levels.append(Level(spec=next_spec,
                                    u=jnp.zeros((next_spec.n,) * 3, cfg.dtype),
                                    f=f_c))
                nodes.append(self._node_report("descend", n, err, taken))

            elif isinstance(ins, CoarseSolve):
                if ins.option == 0:
                    lvl.u = p3.dense_solve3(lvl.f, h)
                    nodes.append(NodeReport("coarse-solve", n, detail="dense"))
                else:
                    if ins.option == 2:
                        dtype = jnp.float32
                    elif ins.option == 1 and jax.config.jax_enable_x64:
                        dtype = jnp.float64
                    else:
                        dtype = cfg.dtype
                    u, err, iters = p3.gauss_seidel_solve3(
                        lvl.f.astype(dtype), h, ins.target_error,
                        norm=cfg.coarse_gs_norm)
                    lvl.u = u.astype(cfg.dtype)
                    rep = self._node_report("coarse-solve", n, err, iters)
                    rep.detail = f"rbgs target={ins.target_error:g}"
                    nodes.append(rep)

            elif isinstance(ins, Ascend):
                if len(levels) < 2:
                    raise RuntimeError("Ascend with no coarser level")
                child = levels.pop()
                lvl = levels[-1]
                n = lvl.spec.n
                lvl.u = _prolong_add3(child.u, lvl.u, n)
                if len(levels) == 1:
                    warm = True
                if ins.steps == 0:
                    nodes.append(NodeReport("ascend", n, steps=0))
                else:
                    lvl.u, err, taken = self._smooth(lvl, ins.steps)
                    nodes.append(self._node_report("ascend", n, err, taken))
            else:
                raise TypeError(f"unknown instruction {ins!r}")

            if cfg.collect_node_stats:
                logger.info("%s", nodes[-1])

        final = levels[-1]
        final.u.block_until_ready()
        wall = time.perf_counter() - start

        err_vs_analytic = None
        if self.problem.analytic is not None:
            ua = self.problem.analytic_grid(final.spec.n, cfg.dtype)
            err_vs_analytic = float(jnp.mean(jnp.abs(final.u - ua)))

        return SolveReport(u=final.u, spec=final.spec, wall_time_s=wall,
                           nodes=nodes, error_vs_analytic=err_vs_analytic)

    def _smooth(self, lvl: Level, steps: int):
        cfg = self.config
        h = lvl.spec.h
        compat = "gpu" if cfg.compat_error == "gpu" else "clean"
        if steps == -1:
            return p3.trigger_smooth3(
                lvl.u, lvl.f, h, cfg.trigger, cfg.omega, compat,
                cfg.smoother, cfg.max_trigger_sweeps)
        u, err = p3.smooth3(lvl.u, lvl.f, h, steps=steps, omega=cfg.omega,
                            compat=compat, smoother=cfg.smoother)
        return u, err, steps

    def _node_report(self, kind: str, n: int, err, steps) -> NodeReport:
        if self.config.collect_node_stats:
            return NodeReport(kind, n,
                              steps=int(steps) if steps is not None else None,
                              error=float(err) if err is not None else None)
        return NodeReport(kind, n)


def solve3_program(problem: Problem3D, program: CycleProgram,
                   config: SolverConfig = SolverConfig()) -> SolveReport:
    """One-call convenience wrapper (3-D analog of solver.solve)."""
    return Solver3D(problem, config).run(program)
