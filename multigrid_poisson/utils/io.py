"""Solution I/O: CSV writer byte-compatible with the reference's Sol_* dumps.

The reference writes the final grid as comma-separated ``%lf`` values, rows
ordered top-to-bottom in y (doPrint2File, MG_solver_CPU.cpp:735-754), to a file
named ``Sol_CPU_<cyclefile>`` / ``Sol_GPU_<cyclefile>`` (MG_solver_CPU.cpp:453-459).
This writer reproduces that format exactly so the reference's plot scripts
(plot/plot.py, plot/plot3D.py) work unchanged on our output.

For large grids an optional C++ fast path (utils.native) formats the rows in
parallel; the numpy path is the always-available fallback.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np


def solution_filename(cycle_file: str | os.PathLike, prefix: str = "Sol_GPU_") -> str:
    """Mirror the reference naming: prefix + the schedule file's basename."""
    return prefix + Path(cycle_file).name


def write_solution_csv(u, path: str | os.PathLike, decimals: int = 6) -> None:
    """Write a grid as CSV, top y row first, ``%.6f``-style fixed-point.

    Matches doPrint2File: row j = N-1 down to 0, each row the x values
    comma-separated with a trailing newline.
    """
    arr = np.asarray(u)
    if arr.ndim != 2:
        raise ValueError(f"expected a 2D grid, got shape {arr.shape}")
    flipped = arr[::-1, :]  # top-to-bottom in y
    try:
        from ..native import write_csv_native

        if write_csv_native(flipped, str(path), decimals):
            return
    except ImportError:
        pass
    with open(path, "w") as fh:
        for row in flipped:
            fh.write(",".join(f"{v:.{decimals}f}" for v in row))
            fh.write("\n")


def format_grid(u, decimals: int = 3) -> str:
    """Console grid dump in the reference's doPrint layout
    (MG_solver_CPU.cpp:726-733): rows printed top y first, values as
    ``%2.3e``-style scientific with a trailing space per value."""
    arr = np.asarray(u)
    if arr.ndim != 2:
        raise ValueError(f"expected a 2D grid, got shape {arr.shape}")
    return "\n".join(
        "".join(f"{v:2.{decimals}e} " for v in row) for row in arr[::-1, :])


def print_grid(u, decimals: int = 3) -> None:
    print(format_grid(u, decimals))


def read_solution_csv(path: str | os.PathLike) -> np.ndarray:
    """Read a Sol_* CSV back into a [iy, ix] grid (undoing the y flip)."""
    data = np.loadtxt(path, delimiter=",", ndmin=2)
    return data[::-1, :]
