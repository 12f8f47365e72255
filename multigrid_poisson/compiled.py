"""Whole-cycle compilation: a CycleProgram becomes ONE jitted XLA program.

This replaces the reference's interpreter loop
(``while(!f_read.eof())`` dispatching one numerical call at a time,
MG_solver_CPU.cpp:158-426) and its per-op host↔device churn
(MG_solver_GPU.cu:1184-1278). A cycle schedule is *static data*: every level
shape, sweep count, and restriction target is known before the first flop.
So instead of interpreting it node by node, we trace the entire schedule —
every smoothing sweep, restriction, coarse solve, and prolongation across all
levels — into a single XLA computation:

  * zero host round-trips inside a cycle (the reference GPU does several per
    *op*; its GS coarse solver syncs the host every iteration,
    MG_solver_GPU.cu:1507-1522);
  * level arrays live in the padded layout (ops.layout) for the whole
    cycle, so no level is repacked between operations;
  * data-dependent pieces (error-trigger sweeps, coarse GS convergence) stay
    on device as ``lax.while_loop``s with scalar predicates;
  * multi-chip: per-level ``with_sharding_constraint`` annotations let GSPMD
    partition every stencil over the row axis of a device mesh and insert
    halo collective-permutes / reduction psums itself — levels below the
    sharding threshold are replicated (coarse-level agglomeration).

The interpreted engine (solver.MultigridSolver) remains the instrumented /
parity-reporting path; this module is the performance path. Both execute the
same CycleProgram semantics (including warm-restart, linkedlist.h:38-41).
"""

from __future__ import annotations

import dataclasses
import sys
from functools import partial
from typing import Any, Optional

def _ensure_trace_recursion_limit():
    """Tracing a whole deep-hierarchy schedule (11 levels at N=8193, every
    sweep unrolled) nests Python frames beyond the default 1000 limit, and
    JAX's jaxpr traversals recurse proportionally to the op chain. Raised
    lazily when an engine is built (not at import) so merely importing the
    package doesn't change process-wide limits."""
    if sys.getrecursionlimit() < 50_000:
        sys.setrecursionlimit(50_000)

import jax
import jax.numpy as jnp
from jax import lax

from .grid import GridSpec
from .models.problems import Problem
from .ops import coarse as coarse_ops
from .ops import padded as P
from .ops.layout import interior_mask, pad_grid_to, padded_shape, unpad_grid
from .parallel.mesh import ShardingPolicy
from .schedule import Ascend, CoarseSolve, CycleProgram, Descend
from .solver import SolverConfig


def _pshape(n: int, policy: Optional[ShardingPolicy]) -> tuple[int, int]:
    """Padded shape for level n: policy-aware so sharded levels split into
    equal per-device blocks (parallel.mesh.padded_shape)."""
    return padded_shape(n) if policy is None else policy.padded_shape(n)


@dataclasses.dataclass
class _TraceLevel:
    spec: GridSpec
    u: Any
    f: Any
    is_fmg: bool = False


class CompiledCycle:
    """A CycleProgram compiled end-to-end into one XLA executable.

    Arrays flow in the padded layout: ``init()`` produces padded
    ``(u0, f0)``; calling the object returns ``(u, err)`` with ``u`` padded;
    ``unpad(u)`` recovers the true (n, n) grid.

    Warm restart (the reference's init-flag behavior, linkedlist.h:38-41):
    with the default ``warm=False`` every call RESETS the finest iterate, so
    chaining the output into the same instance repeats cycle 1. To iterate
    cycles, either build a second instance with ``warm=True`` and chain
    through that, or use :meth:`iterate`, which does both.
    """

    def __init__(self, program: CycleProgram, problem: Problem,
                 config: SolverConfig = SolverConfig(),
                 policy: Optional[ShardingPolicy] = None,
                 warm: bool = False, donate: bool = True):
        _ensure_trace_recursion_limit()
        program.validate()
        self.program = program
        self.problem = problem
        self.config = config
        self.policy = policy
        self.warm = warm
        self.finest_spec = GridSpec(program.n_max, program.length,
                                    program.min_x, program.min_y)
        fn = partial(_run_traced, program=program, problem=problem,
                     config=config, policy=policy, warm=warm)
        self.fn = jax.jit(fn, donate_argnums=(0,) if donate else ())

    # -- data construction ----------------------------------------------------

    def init(self) -> tuple[jnp.ndarray, jnp.ndarray]:
        """Padded, device-resident (u0, f0) for the finest level."""
        cfg, spec = self.config, self.finest_spec

        def build():
            shape = _pshape(spec.n, self.policy)
            f = pad_grid_to(self.problem.source_grid(spec, cfg.dtype)
                            + self.problem.boundary_grid(spec, cfg.dtype),
                            shape)
            u = pad_grid_to(self.problem.boundary_grid(spec, cfg.dtype),
                            shape)
            if self.policy is not None:
                sh = self.policy.sharding(spec.n)
                u = lax.with_sharding_constraint(u, sh)
                f = lax.with_sharding_constraint(f, sh)
            return u, f

        return jax.jit(build)()

    def __call__(self, u, f):
        return self.fn(u, f)

    def iterate(self, cycles: int):
        """Run ``cycles`` warm-restarted cycles as one jitted computation.

        Returns a jitted ``fn(u0, f) -> u`` that executes one cold cycle
        followed by ``cycles − 1`` warm ones (the chained-cycle semantics of
        the reference's init flag).
        """
        warm = CompiledCycle(self.program, self.problem, self.config,
                             self.policy, warm=True, donate=False)

        def chained(u, f):
            u = self.fn(u, f)[0]
            return jax.lax.fori_loop(
                0, cycles - 1, lambda i, v: warm.fn(v, f)[0], u)

        return jax.jit(chained)

    def unpad(self, u: jnp.ndarray) -> jnp.ndarray:
        return unpad_grid(u, self.finest_spec.n)

    def lower_text(self) -> str:
        """StableHLO of the whole cycle (for inspection/tests)."""
        u, f = self.init()
        return str(self.fn.lower(u, f).as_text())


def _constrain(x, policy: Optional[ShardingPolicy], n: int):
    if policy is None:
        return x
    return lax.with_sharding_constraint(x, policy.sharding(n))


def _zoom(cfg: SolverConfig):
    return P.zoom_take_p if cfg.zoom == "take" else P.zoom_p


def _restrict(d, n: int, m: int, cfg: SolverConfig, policy=None):
    """Coarse RHS from the negated fine residual, per the restriction policy."""
    if cfg.restriction == "full_weighting":
        if n != 2 * m - 1:
            # never fall back silently: the user asked for FW because of the
            # rb-GS sampling pathology; degrading to sampling would diverge
            raise ValueError(
                f"restriction='full_weighting' requires 2:1 vertex-aligned "
                f"levels (n == 2m-1), got {n} -> {m}; build the schedule "
                f"with coarsen=3 (odd-halve) or use restriction='sampling'")
        return P.full_weighting_restrict_p(-d, n, m, _pshape(m, policy))
    return _zoom(cfg)(-d, n, m, _pshape(m, policy), zero_boundary=True)


def _sweeps(u, f, h, n: int, steps: int, cfg: SolverConfig,
            from_zero: bool = False):
    """``steps`` smoothing sweeps on padded arrays.

    ``from_zero``: the caller guarantees u ≡ 0 (a freshly-reset correction
    level); the first Jacobi sweep is then closed-form — u₁ = −(ω/4)h²f on
    the interior — and skips reading u.
    """
    if cfg.smoother == "jacobi":
        sweep = partial(P.jacobi_sweep_p, h=h, n=n, omega=cfg.omega)
        if from_zero and steps >= 1:
            u = jnp.where(interior_mask(n, u.shape),
                          (-0.25 * cfg.omega * h * h) * f,
                          jnp.zeros_like(u))
            steps -= 1
    else:
        sweep = partial(P.redblack_gs_sweep_p, h=h, n=n)
    return lax.fori_loop(0, steps, lambda _, v: sweep(v, f), u, unroll=True)


def _trigger_smooth_traced(u, f, h, n: int, cfg: SolverConfig):
    """Device-side error-trigger loop (MG_solver_CPU.cpp:194-240): smooth one
    sweep at a time while |err_k − err_{k−1}| > trigger. The first sweep
    only records the error; the slope test starts at sweep 2."""
    def step(v):
        v_new = _sweeps(v, f, h, n, 1, cfg)
        if cfg.compat_error == "gpu":
            return v_new, P.gpu_smoothing_error_p(v_new, v, h, n)
        return v_new, P.smoothing_error_p(v_new, f, h, n,
                                          compat=cfg.compat_error)

    u, err0 = step(u)

    def cond(state):
        _, _, slope, k = state
        return jnp.logical_and(slope > cfg.trigger,
                               k < cfg.max_trigger_sweeps)

    def body(state):
        u, prev, _, k = state
        u_new, err = step(u)
        return u_new, err, jnp.abs(err - prev), k + 1

    init = (u, err0, jnp.asarray(cfg.trigger + 1.0, err0.dtype),
            jnp.asarray(1, jnp.int32))
    u, err, _, _ = lax.while_loop(cond, body, init)
    return u, err


def _smooth_traced(u, f, h, n: int, steps: int, cfg: SolverConfig,
                   want_err: bool, from_zero: bool = False):
    if steps == -1:
        return _trigger_smooth_traced(u, f, h, n, cfg)
    if want_err and cfg.compat_error == "gpu" and steps >= 1:
        # the GPU metric needs the final sweep's ping-pong pair: run the
        # first steps−1 sweeps, keep the pre-final iterate, sweep once more
        u_prev = (u if steps == 1 else
                  _sweeps(u, f, h, n, steps - 1, cfg, from_zero=from_zero))
        u = _sweeps(u_prev, f, h, n, 1, cfg,
                    from_zero=from_zero and steps == 1)
        return u, P.gpu_smoothing_error_p(u, u_prev, h, n)
    u = _sweeps(u, f, h, n, steps, cfg, from_zero=from_zero)
    err = (P.smoothing_error_p(u, f, h, n, compat=cfg.compat_error)
           if want_err else None)
    return u, err


def _coarse_solve_traced(f_pad, h, n: int, ins: CoarseSolve, cfg: SolverConfig,
                         policy=None):
    """Exact solve on the (tiny) coarsest level: unpad → solve → repad.

    Coarse grids are far below the tile-alignment scales, so the slice/pad
    round-trip is noise; the solvers themselves are unchanged
    (doExactSolver options, MG_solver_CPU.cpp:627-638)."""
    f = unpad_grid(f_pad, n)
    if ins.option == 0:
        u = coarse_ops.dense_solve(f, h)
    else:
        # option 1 is the reference's fp64 GS (doExactSolver_GPU option 1,
        # MG_solver_GPU.cu:1296): run in float64 when x64 is enabled,
        # otherwise in the configured dtype (where the compensated metric +
        # stagnation stop handle the fp32 floor); option 2 is explicit fp32
        if ins.option == 2:
            dt = jnp.float32
        elif ins.option == 1 and jax.config.jax_enable_x64:
            dt = jnp.float64
        else:
            dt = cfg.dtype
        u, _, _ = coarse_ops.gauss_seidel_solve(
            f.astype(dt), h, ins.target_error, norm=cfg.coarse_gs_norm)
        u = u.astype(cfg.dtype)
    return pad_grid_to(u, _pshape(n, policy))


def _run_traced(u0, f0, *, program: CycleProgram, problem: Problem,
                config: SolverConfig, policy: Optional[ShardingPolicy],
                warm: bool):
    """Trace the full instruction sequence on padded arrays.

    Returns (u_finest_padded, last_err) where last_err is the most recent
    finest-level smoothing error (device scalar, no extra passes)."""
    cfg = config
    finest_spec = GridSpec(program.n_max, program.length,
                           program.min_x, program.min_y)
    levels = [_TraceLevel(finest_spec, u0, f0)]
    warm_now = warm
    last_err = jnp.asarray(0.0, cfg.dtype)

    def boundary_pad(spec):
        return pad_grid_to(problem.boundary_grid(spec, cfg.dtype),
                           _pshape(spec.n, policy))

    def zeros_pad(spec):
        return jnp.zeros(_pshape(spec.n, policy), cfg.dtype)

    for ins in program.instructions:
        lvl = levels[-1]
        n, h = lvl.spec.n, lvl.spec.h

        if isinstance(ins, Descend):
            finest = len(levels) == 1
            was_zeroed = False
            if not (finest and warm_now) and not lvl.is_fmg:
                # reference memset semantics (MG_solver_CPU.cpp:209-214)
                lvl.u = _constrain(
                    boundary_pad(lvl.spec) if finest else zeros_pad(lvl.spec),
                    policy, n)
                was_zeroed = not finest   # correction levels reset to u ≡ 0

            next_spec = lvl.spec.coarsened(ins.next_n)
            m = ins.next_n
            if ins.steps == 0:
                # FMG descent: restrict the full RHS, no smoothing
                # (the reference's TODO branch, MG_solver_CPU.cpp:296-299).
                f_c = _zoom(cfg)(lvl.f, n, m, _pshape(m, policy),
                                 zero_boundary=True)
                f_c = f_c + boundary_pad(next_spec)
                levels.append(_TraceLevel(
                    next_spec, _constrain(zeros_pad(next_spec), policy, m),
                    _constrain(f_c, policy, m), is_fmg=True))
                continue

            lvl.u, err = _smooth_traced(lvl.u, lvl.f, h, n, ins.steps,
                                        cfg, want_err=finest,
                                        from_zero=was_zeroed)
            lvl.u = _constrain(lvl.u, policy, n)
            d = P.residual_p(lvl.u, lvl.f, h, n)
            f_c = _restrict(d, n, m, cfg, policy)
            if finest and err is not None:
                last_err = err
            levels.append(_TraceLevel(
                next_spec, _constrain(zeros_pad(next_spec), policy, m),
                _constrain(f_c, policy, m)))

        elif isinstance(ins, CoarseSolve):
            lvl.u = _constrain(
                _coarse_solve_traced(lvl.f, h, n, ins, cfg, policy),
                policy, n)

        elif isinstance(ins, Ascend):
            child = levels.pop()
            lvl = levels[-1]
            n, h = lvl.spec.n, lvl.spec.h
            if len(levels) == 1:
                warm_now = True
            finest = len(levels) == 1
            corr = _zoom(cfg)(child.u, child.spec.n, n,
                              _pshape(n, policy))
            lvl.u = _constrain(P.add_correction_p(lvl.u, corr, n), policy, n)
            if ins.steps != 0:
                lvl.u, err = _smooth_traced(lvl.u, lvl.f, h, n, ins.steps,
                                            cfg, want_err=finest)
                lvl.u = _constrain(lvl.u, policy, n)
                if finest and err is not None:
                    last_err = err
        else:  # pragma: no cover
            raise TypeError(f"unknown instruction {ins!r}")

    return levels[0].u, last_err


def compile_program(program: CycleProgram, problem: Problem,
                    config: SolverConfig = SolverConfig(),
                    policy: Optional[ShardingPolicy] = None,
                    warm: bool = False, donate: bool = True) -> CompiledCycle:
    """Compile ``program`` for ``problem`` into a single jitted callable."""
    return CompiledCycle(program, problem, config, policy, warm, donate)
