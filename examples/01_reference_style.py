"""Reference-style run: a bundled Cycle.txt schedule, both engines.

Equivalent of ``./MG_CPU 4 Vcycle.txt`` (reference README.md:130-139).

    python examples/01_reference_style.py [schedules/Vcycle.txt]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import sys

import multigrid_poisson as mg


def main(cycle_file="schedules/Vcycle.txt"):
    program = mg.parse_cycle_path(cycle_file)
    print(f"schedule: {cycle_file}: N={program.n_max}, "
          f"{len(program.instructions)} instructions")

    # interpreted engine: per-node stats, like the reference's narration
    report = mg.solve(mg.REFERENCE_PROBLEM, program)
    print("[interpreted]", report.summary().replace("\n", " | "))

    # compiled engine: the whole schedule as one XLA program
    cc = mg.compile_program(program, mg.REFERENCE_PROBLEM, donate=False)
    u, f = cc.init()
    u, err = cc(u, f)
    ua = mg.REFERENCE_PROBLEM.analytic_grid(cc.finest_spec)
    from multigrid_poisson.ops.stencils import mean_abs_error

    print(f"[compiled]    Error = {float(mean_abs_error(cc.unpad(u), ua)):.6e}")


if __name__ == "__main__":
    main(*sys.argv[1:])
