"""CLI and solution-I/O tests."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

from multigrid_poisson.utils.io import (
    read_solution_csv,
    solution_filename,
    write_solution_csv,
)

SCHEDULES = pathlib.Path(__file__).resolve().parent.parent / "schedules"


def test_solution_filename():
    assert solution_filename("/a/b/Vcycle.txt") == "Sol_GPU_Vcycle.txt"


def test_csv_roundtrip(tmp_path, rng):
    u = rng.random((9, 9))
    path = tmp_path / "sol.csv"
    write_solution_csv(u, path)
    back = read_solution_csv(path)
    np.testing.assert_allclose(back, u, atol=5e-7)  # %.6f quantization


def test_format_grid_matches_doprint_layout():
    """Console dump layout of doPrint (MG_solver_CPU.cpp:726-733): top y row
    first, %2.3e values each followed by a space."""
    from multigrid_poisson.utils.io import format_grid

    u = np.arange(4.0).reshape(2, 2)
    lines = format_grid(u).splitlines()
    assert lines[0] == "2.000e+00 3.000e+00 "
    assert lines[1] == "0.000e+00 1.000e+00 "


def test_csv_format_matches_reference_layout(tmp_path):
    """Rows top-to-bottom in y, comma separators, fixed %.6f (doPrint2File)."""
    u = np.arange(9.0).reshape(3, 3)  # u[iy, ix]
    path = tmp_path / "sol.csv"
    write_solution_csv(u, path)
    lines = path.read_text().splitlines()
    assert lines[0] == "6.000000,7.000000,8.000000"  # top y row first
    assert lines[2] == "0.000000,1.000000,2.000000"


def run_cli(args, cwd):
    env_cmd = (
        "import jax; jax.config.update('jax_platforms', 'cpu'); "
        "import sys; from multigrid_poisson.cli import main; "
        "sys.exit(main(sys.argv[1:]))"
    )
    return subprocess.run(
        [sys.executable, "-c", env_cmd, *args],
        capture_output=True, text=True, cwd=cwd,
        env={"PYTHONPATH": str(SCHEDULES.parent), "PATH": "/usr/bin:/bin:/usr/local/bin",
             "HOME": "/root"},
    )


@pytest.mark.slow
def test_cli_end_to_end(tmp_path):
    res = run_cli(["4", str(SCHEDULES / "test.txt"), "--dtype", "f64", "--quiet"],
                  cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    assert "===== Final Result =====" in res.stdout
    assert "Error = 6.6" in res.stdout  # 6.658e-04, reference parity
    out = tmp_path / "Sol_GPU_test.txt"
    assert out.exists()
    grid = read_solution_csv(out)
    assert grid.shape == (16, 16)


def test_solution_csv_byte_identical_to_reference_binary(tmp_path):
    """The f64 run of schedules/test.txt produces a CSV byte-identical to the
    compiled reference binary's Sol_CPU_test.txt (verified once offline and
    frozen in tests/data) — format AND numerics parity in one check."""
    import jax.numpy as jnp

    from multigrid_poisson import (
        REFERENCE_PROBLEM, SolverConfig, parse_cycle_path, solve,
    )

    rep = solve(REFERENCE_PROBLEM, parse_cycle_path(SCHEDULES / "test.txt"),
                SolverConfig(dtype=jnp.float64))
    out = tmp_path / "sol.csv"
    write_solution_csv(rep.u, out)
    expected = (pathlib.Path(__file__).parent / "data" / "Sol_expected_test.txt").read_text()
    assert out.read_text() == expected


@pytest.mark.slow
def test_cli_rejects_missing_file(tmp_path):
    res = run_cli(["nonexistent.txt"], cwd=tmp_path)
    assert res.returncode == 1
    assert "Cannot open" in res.stderr


@pytest.mark.slow
def test_cli_3d_deep_solve(tmp_path):
    """--dim 3 --tol: the 3-D refinement deep-solve mode end to end."""
    res = run_cli(["1", str(SCHEDULES / "test.txt"), "--dim", "3",
                   "--tol", "1e-9", "--state", "tw32", "--quiet"],
                  cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    assert "Relative residual = " in res.stdout
    rel = float(res.stdout.split("Relative residual = ")[1].split()[0])
    assert rel <= 1e-9
    assert (tmp_path / "Sol_GPU_test.txt.npz").exists()
