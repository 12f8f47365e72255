"""Whole-schedule compiled 3-D engine: one XLA program per CycleProgram.

The 3-D analog of compiled.py: the entire instruction walk — every smoothing
sweep, residual+restriction, coarse solve, and prolongation+add on every
level — is traced into ONE jitted function. Level shapes are static, trigger
loops and the red-black GS coarse solve are device-side ``lax.while_loop``s,
so a chained multi-cycle schedule runs with zero host round-trips.

Node semantics match solver3.Solver3D exactly (same ops); the consistency
test (tests/test_compiled3.py) pins the two engines together, mirroring the
2-D interpreted-vs-compiled contract.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from .grid import GridSpec
from .models import poisson3d as p3
from .models.poisson3d import Problem3D
from .ops.zoom import zoom3
from .schedule import Ascend, CoarseSolve, CycleProgram, Descend
from .solver import SolverConfig
from .solver3 import _prolong_add3, _restrict_residual3


def _trace_program3(u, f, *, program: CycleProgram, problem: Problem3D,
                    config: SolverConfig, policy=None, warm: bool):
    """The traced instruction walk. ``u``/``f`` are the finest-level arrays;
    returns (u_final, last_smoothing_error).

    ``policy`` (parallel.mesh.ZShardingPolicy3) makes the SAME instruction
    walk multi-device: every level array is constrained to the policy's
    sharding for its size — contiguous z-plane blocks while the level is
    large, replicated below the threshold (coarse-level agglomeration) — and
    GSPMD partitions the plain-jnp ops, inserting the plane-halo collectives
    and the reductions of the error metrics itself."""
    cfg = config
    compat = "gpu" if cfg.compat_error == "gpu" else "clean"
    spec0 = GridSpec(program.n_max, program.length, program.min_x,
                     program.min_y)

    def cz(a, n):
        """Constrain a level-n array to its policy sharding (identity
        single-device)."""
        if policy is None:
            return a
        return jax.lax.with_sharding_constraint(a, policy.sharding(n))

    def smooth(lu, lf, h, steps):
        if steps == -1:
            u, err, _ = p3.trigger_smooth3(
                lu, lf, h, cfg.trigger, cfg.omega, compat, cfg.smoother,
                cfg.max_trigger_sweeps)
            return u, err
        return p3.smooth3(lu, lf, h, steps=steps, omega=cfg.omega,
                          compat=compat, smoother=cfg.smoother)

    def zeros_level(n):
        return cz(jnp.zeros((n,) * 3, cfg.dtype), n)

    def zero_interior(lu, n):
        """Re-zero the correction interior, keeping the Dirichlet border."""
        return jnp.where(
            jnp.zeros((n,) * 3, bool).at[1:-1, 1:-1, 1:-1].set(True),
            jnp.zeros_like(lu), lu)

    # stack of (spec, u, f, is_fmg); mirrors Solver3D.run
    levels = [(spec0, cz(u, spec0.n), cz(f, spec0.n), False)]
    first_descend_done = warm
    last_err = jnp.zeros((), cfg.dtype)

    for ins in program.instructions:
        spec, lu, lf, is_fmg = levels[-1]
        n, h = spec.n, spec.h

        if isinstance(ins, Descend):
            finest = len(levels) == 1
            if not (finest and first_descend_done) and not is_fmg:
                if finest:
                    lu = zero_interior(lu, n)  # keep Dirichlet border
                else:
                    lu = zeros_level(n)

            next_spec = spec.coarsened(ins.next_n)
            m = ins.next_n
            if ins.steps == 0:  # FMG descent
                f_c = zoom3(lf, m, zero_boundary=True)
                f_c = cz(f_c + problem.boundary_grid(m, cfg.dtype), m)
                levels[-1] = (spec, lu, lf, is_fmg)
                levels.append((next_spec, zeros_level(m), f_c, True))
                continue

            lu, last_err = smooth(lu, lf, h, ins.steps)
            lu = cz(lu, n)
            f_c = cz(_restrict_residual3(lu, lf, h, m,
                                         restriction=cfg.restriction), m)
            levels[-1] = (spec, lu, lf, is_fmg)
            levels.append((next_spec, zeros_level(m), f_c, False))

        elif isinstance(ins, CoarseSolve):
            if ins.option == 0:
                lu = p3.dense_solve3(lf, h)
            else:
                if ins.option == 2:
                    dtype = jnp.float32
                elif ins.option == 1 and jax.config.jax_enable_x64:
                    dtype = jnp.float64
                else:
                    dtype = cfg.dtype
                us, last_err, _ = p3.gauss_seidel_solve3(
                    lf.astype(dtype), h, ins.target_error,
                    norm=cfg.coarse_gs_norm)
                lu = us.astype(cfg.dtype)
            levels[-1] = (spec, cz(lu, n), lf, is_fmg)

        elif isinstance(ins, Ascend):
            child_spec, cu, _, _ = levels.pop()
            spec, lu, lf, is_fmg = levels[-1]
            n, h = spec.n, spec.h
            lu = cz(_prolong_add3(cu, lu, n), n)
            if ins.steps != 0:
                lu, last_err = smooth(lu, lf, h, ins.steps)
                lu = cz(lu, n)
            if len(levels) == 1:
                first_descend_done = True
            levels[-1] = (spec, lu, lf, is_fmg)
        else:
            raise TypeError(f"unknown instruction {ins!r}")

    return levels[-1][1], last_err


@dataclasses.dataclass
class CompiledCycle3:
    """A CycleProgram traced into one jitted 3-D executable."""

    program: CycleProgram
    problem: Problem3D
    config: SolverConfig
    _fn: object
    _fn_warm: object
    policy: Optional[object] = None

    @property
    def finest_spec(self) -> GridSpec:
        p = self.program
        return GridSpec(p.n_max, p.length, p.min_x, p.min_y)

    def init(self):
        n = self.program.n_max
        dtype = self.config.dtype
        f = (self.problem.source_grid(n, dtype)
             + self.problem.boundary_grid(n, dtype))
        u = self.problem.boundary_grid(n, dtype)
        # no device_put here: the traced walk constrains the finest level
        # to the policy's sharding
        return u, f

    def __call__(self, u, f, warm: bool = False):
        return (self._fn_warm if warm else self._fn)(u, f)


def compile_program3(program: CycleProgram, problem: Problem3D,
                     config: SolverConfig = SolverConfig(),
                     policy=None, donate: bool = False) -> CompiledCycle3:
    """Build the one-XLA-program 3-D executable for ``program``.

    ``policy`` (parallel.mesh.ZShardingPolicy3) runs the program
    multi-device under a z-plane decomposition: large levels keep their
    state partitioned, coarser levels replicate (see _trace_program3)."""
    program.validate()

    def make(warm: bool):
        fn = partial(_trace_program3, program=program, problem=problem,
                     config=config, policy=policy, warm=warm)
        return jax.jit(fn, donate_argnums=(0,) if donate else ())

    return CompiledCycle3(program, problem, config, make(False), make(True),
                          policy)
