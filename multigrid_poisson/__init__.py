"""multigrid_poisson — a geometric-multigrid Poisson framework in JAX.

A from-scratch JAX/XLA re-architecture of the capability set of
cindytsai/multigrid_poisson_solver (2D Poisson, Dirichlet boundary, scriptable
V/W/FMG multigrid cycles): device-resident level hierarchies, whole-schedule
compilation into one XLA program, and GSPMD / ``shard_map`` grid partitioning
with collective-permute halo exchange.
"""

__version__ = "0.1.0"

from .grid import GridSpec, level_sizes  # noqa: F401
from .models import Problem, REFERENCE_PROBLEM, BUILTIN_PROBLEMS  # noqa: F401
from .schedule import (  # noqa: F401
    Ascend,
    CoarseSolve,
    CycleProgram,
    Descend,
    fmg,
    parse_cycle_file,
    parse_cycle_path,
    repeat,
    to_cycle_file,
    v_cycle,
    w_cycle,
)
from .solver import MultigridSolver, SolveReport, SolverConfig, solve  # noqa: F401
from .solver3 import Solver3D, solve3_program  # noqa: F401
from .compiled3 import CompiledCycle3, compile_program3  # noqa: F401
from .models import BUILTIN_PROBLEMS_3D, Problem3D, REFERENCE_PROBLEM_3D  # noqa: F401
from .compiled import CompiledCycle, compile_program  # noqa: F401
from .refine import IterativeRefinementSolver, RefineReport, solve_to_tolerance  # noqa: F401
from .refine3 import IterativeRefinement3, Refine3Report, solve_to_tolerance3  # noqa: F401
from . import models  # noqa: F401
