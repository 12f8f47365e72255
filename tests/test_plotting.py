"""Plot-tool smoke tests (the reference's plot/ analog, C20)."""

import matplotlib

matplotlib.use("Agg")

import numpy as np
import pytest

from multigrid_poisson.models import poisson3d as p3
from multigrid_poisson.models.problems import REFERENCE_PROBLEM
from multigrid_poisson.utils.plotting import (
    comparison_figure, slice_figure3, surface_figure,
)


def test_comparison_figure(rng):
    fig = comparison_figure(rng.random((17, 17)))
    assert len(fig.axes) >= 3


def test_surface_figure(rng):
    fig = surface_figure(rng.random((17, 17)))
    assert fig.axes


def test_slice_figure3_with_analytic():
    u = np.asarray(p3.REFERENCE_PROBLEM_3D.analytic_grid(17))
    fig = slice_figure3(u, problem=p3.REFERENCE_PROBLEM_3D)
    assert len(fig.axes) >= 3      # numerical, analytic, |diff| (+ colorbars)


def test_slice_figure3_plain(rng):
    fig = slice_figure3(rng.random((9, 9, 9)), axis=2, index=4)
    assert fig.axes


def test_plotting_cli_npz(tmp_path, rng):
    from multigrid_poisson.utils import plotting

    u = np.asarray(p3.REFERENCE_PROBLEM_3D.analytic_grid(9))
    npz = tmp_path / "Sol_x.npz"
    np.savez_compressed(npz, u=u)
    out = tmp_path / "x.png"
    assert plotting.main([str(npz), str(out)]) == 0
    assert out.exists()
