"""The multigrid engine: executes a CycleProgram on a device-resident hierarchy.

This is the device-resident re-architecture of the reference's scheduler loop
(main() while(!eof), MG_solver_CPU.cpp:158-426) and its LinkedList level stack
(linkedlist.cpp). Differences by design:

  * The hierarchy is a Python list of immutable per-level arrays that live on
    device for the entire run — no per-op host↔device round trips (the
    reference GPU re-uploads every array for every op, MG_solver_GPU.cu:1184-1278).
  * Level shapes are static, so each (op, N) pair compiles exactly once and is
    reused across cycles (jit cache); the host only sequences instructions.
  * The error-trigger loop is a device-side ``lax.while_loop`` — the smoothing
    error never visits the host (the reference syncs it every sweep).
  * Dirichlet data convention: ``f`` arrays carry the boundary values on their
    border and the PDE right-hand side inside (the layout InverseMatrix's
    identity rows expect, MG_solver_CPU.cpp:802-832); ``u`` arrays carry the
    boundary on their border at all times, and smoothers only touch the
    interior.

Reference-parity behaviors kept deliberately:
  * every Descend re-zeroes the current level's correction before smoothing,
    except the warm-restart case — finest level with a previously completed
    cycle (init flag, linkedlist.h:38-41, used MG_solver_CPU.cpp:209-214);
    note this means mid-W-cycle descends discard the level's correction, as
    the reference does.
  * the exact solvers start from zero (MG_solver_CPU.cpp:993).
  * smoothing-error metric defaults to the reference's color-bugged variant
    (see ops.stencils.smoothing_error) so trigger schedules run the same
    number of sweeps.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from functools import partial
from typing import Any, Optional

import jax
import jax.numpy as jnp

from .grid import GridSpec
from .models.problems import Problem
from .ops import coarse as coarse_ops
from .ops import stencils
from .ops.zoom import zoom as _zoom
from .schedule import Ascend, CoarseSolve, CycleProgram, Descend, TRIGGER_DEFAULT

logger = logging.getLogger("multigrid_poisson")


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Numerical policy for a solver instance."""

    dtype: Any = jnp.float32
    smoother: str = "jacobi"          # "jacobi" | "rbgs"
    omega: float = 1.0                # Jacobi damping (reference uses 1.0)
    compat_error: Any = True          # trigger metric: True (CPU color-bugged
                                      # sum, MG_solver_CPU.cpp:606-622), False
                                      # (clean mean |residual|), or "gpu" (the
                                      # GPU ping-pong |ΔU|·4/h² of the last
                                      # sweep, MG_solver_GPU.cu:633)
    trigger: float = TRIGGER_DEFAULT  # |Δerr| threshold for step == -1
    max_trigger_sweeps: int = 100_000
    coarse_gs_norm: str = "interior"  # "interior" (CPU ref) | "full" (GPU ref)
    collect_node_stats: bool = True   # pull per-node scalars to host (off for benches)
    zoom: str = "take"                # "take" (two-tap gathers) | "matmul"
                                      # (two dense interpolation matmuls at
                                      # HIGHEST precision)
    restriction: str = "sampling"     # "sampling" (reference semantics,
                                      # doRestriction) | "full_weighting"
                                      # (2:1-aligned levels only; REQUIRED for
                                      # the rbgs smoother — sampling aliases
                                      # its one-color residual)


@dataclasses.dataclass
class Level:
    spec: GridSpec
    u: jnp.ndarray
    f: jnp.ndarray
    is_fmg: bool = False  # pushed by an FMG descent (f is a restricted RHS, not a residual)


@dataclasses.dataclass
class NodeReport:
    kind: str
    n: int
    steps: Optional[int] = None
    error: Optional[float] = None
    detail: str = ""


@dataclasses.dataclass
class SolveReport:
    u: jnp.ndarray
    spec: GridSpec
    wall_time_s: float
    nodes: list[NodeReport]
    error_vs_analytic: Optional[float] = None

    def summary(self) -> str:
        lines = ["===== Final Result ====="]
        if self.error_vs_analytic is not None:
            lines.append(f"    Error = {self.error_vs_analytic:.6e}")
        lines.append(f"Time Used = {self.wall_time_s * 1e3:.3f} (ms)")
        return "\n".join(lines)


# --- fused jitted level ops ---------------------------------------------------

@partial(jax.jit, static_argnames=("h", "m", "restriction"))
def _restrict_residual_fused(u, f, h: float, m: int, restriction: str = "sampling"):
    """residual → negate → restriction → zero boundary, one compiled graph.

    The scheduler's down-leg tail: MG_solver_CPU.cpp:268-287 (getResidual,
    sign flip, doRestriction), fused so the residual never round-trips to HBM
    more than once. ``restriction`` follows SolverConfig.restriction:
    "sampling" (reference bilinear) or "full_weighting" (2:1-aligned only —
    REQUIRED for the rbgs smoother, whose one-color residual aliases under
    sampling).
    """
    d = stencils.residual(u, f, h)
    n = u.shape[0]
    if restriction == "full_weighting":
        if n != 2 * m - 1:
            # never fall back silently: FW is requested to avoid the rb-GS
            # sampling pathology; degrading to sampling would diverge
            raise ValueError(
                f"restriction='full_weighting' requires 2:1 vertex-aligned "
                f"levels (n == 2m-1), got {n} -> {m}; build the schedule "
                f"with coarsen=3 (odd-halve) or use restriction='sampling'")
        from .ops.layout import pad_grid, padded_shape, unpad_grid
        from .ops.padded import full_weighting_restrict_p

        return unpad_grid(
            full_weighting_restrict_p(pad_grid(-d), n, m, padded_shape(m)), m)
    return _zoom(-d, m, zero_boundary=True)


@partial(jax.jit, static_argnames=("n",))
def _prolong_add(u_coarse, u_fine, n: int):
    """zoom coarse→fine and add into the fine interior (doProlongation +
    doGridAddition, MG_solver_CPU.cpp:350-368), keeping the fine boundary exact."""
    corr = _zoom(u_coarse, n)
    return u_fine.at[1:-1, 1:-1].add(corr[1:-1, 1:-1])


@partial(jax.jit, static_argnames=("h", "trigger", "omega", "compat", "smoother", "max_sweeps"))
def _trigger_smooth(u, f, h: float, trigger: float, omega: float, compat: bool,
                    smoother: str, max_sweeps: int):
    """Error-triggered smoothing: sweep while |err_k − err_{k−1}| > trigger.

    Mirrors the reference trigger loops (MG_solver_CPU.cpp:194-240, 376-408):
    the first sweep only records the error; the slope test starts at sweep 2.
    Entirely device-side (the convergence scalar never leaves the chip).
    """
    sweep = {"jacobi": partial(stencils.jacobi_sweep, omega=omega),
             "rbgs": stencils.redblack_gs_sweep}[smoother]

    def err_of(u_new, u_old):
        if compat == "gpu":
            return stencils.gpu_smoothing_error(u_new, u_old, h)
        return stencils.smoothing_error(u_new, f, h, compat=compat)

    u0 = u
    u = sweep(u, f, h)
    err0 = err_of(u, u0)

    def cond(state):
        _, _, slope, k = state
        return jnp.logical_and(slope > trigger, k < max_sweeps)

    def body(state):
        u, prev, _, k = state
        u_new = sweep(u, f, h)
        err = err_of(u_new, u)
        return u_new, err, jnp.abs(err - prev), k + 1

    init = (u, err0, jnp.asarray(trigger + 1.0, err0.dtype), jnp.asarray(1, jnp.int32))
    u, err, _, k = jax.lax.while_loop(cond, body, init)
    return u, err, k


class MultigridSolver:
    """Executes CyclePrograms for one Problem under one numerical policy."""

    def __init__(self, problem: Problem, config: SolverConfig = SolverConfig()):
        self.problem = problem
        self.config = config

    # -- level construction ----------------------------------------------------

    def _finest_level(self, program: CycleProgram) -> Level:
        spec = GridSpec(program.n_max, program.length, program.min_x, program.min_y)
        dtype = self.config.dtype
        f = self.problem.source_grid(spec, dtype) + self.problem.boundary_grid(spec, dtype)
        u = self.problem.boundary_grid(spec, dtype)
        return Level(spec=spec, u=u, f=f)

    def _reset_u(self, level: Level, finest: bool) -> jnp.ndarray:
        """The array a Descend resets ``u`` to: Dirichlet data at the finest level,
        zeros on correction levels (reference memset, MG_solver_CPU.cpp:209-214)."""
        if finest:
            return self.problem.boundary_grid(level.spec, self.config.dtype)
        return jnp.zeros(level.spec.shape, self.config.dtype)

    # -- main entry --------------------------------------------------------------

    def run(self, program: CycleProgram) -> SolveReport:
        cfg = self.config
        levels: list[Level] = [self._finest_level(program)]
        warm = False  # becomes True once a cycle returns to the finest level
        nodes: list[NodeReport] = []

        start = time.perf_counter()
        for ins in program.instructions:
            lvl = levels[-1]
            n, h = lvl.spec.n, lvl.spec.h

            if isinstance(ins, Descend):
                finest = len(levels) == 1
                # Reference memset semantics (MG_solver_CPU.cpp:209-214): zero the
                # level's correction unless warm-restarting the finest level.
                # FMG solution levels additionally keep their iterate — they hold
                # an approximation of the *solution*, not a correction, so zeroing
                # them would discard the nested-iteration initial guess.
                if not (finest and warm) and not lvl.is_fmg:
                    lvl.u = self._reset_u(lvl, finest)

                if ins.steps == 0:
                    # FMG descent (the reference's TODO branch, MG_solver_CPU.cpp:296-299):
                    # restrict the full RHS, skip smoothing and the residual.
                    next_spec = lvl.spec.coarsened(ins.next_n)
                    f_coarse = _zoom(lvl.f, ins.next_n, zero_boundary=True)
                    f_coarse = f_coarse + self.problem.boundary_grid(next_spec, cfg.dtype)
                    levels.append(Level(spec=next_spec, u=jnp.zeros(next_spec.shape, cfg.dtype),
                                        f=f_coarse, is_fmg=True))
                    nodes.append(NodeReport("fmg-descend", n, steps=0))
                    continue

                lvl.u, err, taken = self._smooth(lvl, ins.steps)
                f_coarse = _restrict_residual_fused(lvl.u, lvl.f, h, ins.next_n,
                                                    restriction=cfg.restriction)
                next_spec = lvl.spec.coarsened(ins.next_n)
                levels.append(Level(spec=next_spec,
                                    u=jnp.zeros(next_spec.shape, cfg.dtype), f=f_coarse))
                nodes.append(self._node_report("descend", n, err, taken))

            elif isinstance(ins, CoarseSolve):
                if ins.option == 0:
                    lvl.u = coarse_ops.dense_solve(lvl.f, h)
                    nodes.append(NodeReport("coarse-solve", n, detail="dense"))
                else:
                    # option 1 = the reference's fp64 GS: float64 when x64 is
                    # enabled, else cfg.dtype; option 2 = explicit fp32
                    # (matches compiled._coarse_solve_traced)
                    if ins.option == 2:
                        dtype = jnp.float32
                    elif ins.option == 1 and jax.config.jax_enable_x64:
                        dtype = jnp.float64
                    else:
                        dtype = cfg.dtype
                    u, err, iters = coarse_ops.gauss_seidel_solve(
                        lvl.f.astype(dtype), h, ins.target_error, norm=cfg.coarse_gs_norm)
                    lvl.u = u.astype(cfg.dtype)
                    rep = self._node_report("coarse-solve", n, err, iters)
                    rep.detail = f"rbgs target={ins.target_error:g}"
                    nodes.append(rep)

            elif isinstance(ins, Ascend):
                if len(levels) < 2:
                    raise RuntimeError("Ascend with no coarser level (malformed schedule)")
                child = levels.pop()
                lvl = levels[-1]
                n = lvl.spec.n
                lvl.u = _prolong_add(child.u, lvl.u, n)
                if len(levels) == 1:
                    warm = True  # init-flag semantics, linkedlist.cpp:63-66
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
            ua = self.problem.analytic_grid(final.spec, cfg.dtype)
            err_vs_analytic = float(stencils.mean_abs_error(final.u, ua))

        return SolveReport(u=final.u, spec=final.spec, wall_time_s=wall,
                           nodes=nodes, error_vs_analytic=err_vs_analytic)

    # -- helpers -----------------------------------------------------------------

    def _smooth(self, lvl: Level, steps: int):
        """Dispatch fixed-step vs trigger smoothing; returns (u, err, steps_taken)."""
        cfg = self.config
        h = lvl.spec.h
        if steps == -1:
            u, err, k = _trigger_smooth(
                lvl.u, lvl.f, h, cfg.trigger, cfg.omega,
                cfg.compat_error, cfg.smoother, cfg.max_trigger_sweeps)
            return u, err, k
        u, err = stencils.smooth(lvl.u, lvl.f, h, steps=steps, omega=cfg.omega,
                                 compat=cfg.compat_error, smoother=cfg.smoother)
        return u, err, steps

    def _node_report(self, kind: str, n: int, err, steps) -> NodeReport:
        if self.config.collect_node_stats:
            return NodeReport(kind, n, steps=int(steps) if steps is not None else None,
                              error=float(err) if err is not None else None)
        return NodeReport(kind, n)


def solve(problem: Problem, program: CycleProgram,
          config: SolverConfig = SolverConfig()) -> SolveReport:
    """One-call convenience wrapper."""
    return MultigridSolver(problem, config).run(program)
