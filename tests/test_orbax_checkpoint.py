"""Orbax checkpoint backend: same SolverState contract as the npz manager,
plus async saves and refinement-loop drop-in."""

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("orbax.checkpoint")

import multigrid_poisson as mg
from multigrid_poisson.utils.checkpoint import SolverState
from multigrid_poisson.utils.orbax_checkpoint import (
    OrbaxCheckpointManager,
)

PROBLEM = mg.REFERENCE_PROBLEM


def test_roundtrip_and_rotation(tmp_path, rng):
    u = rng.random((16, 128)).astype(np.float32)
    f = rng.random((16, 128)).astype(np.float32)
    with OrbaxCheckpointManager(tmp_path / "ck", keep=2,
                                async_save=False) as mgr:
        for cycle in (1, 2, 3):
            st = SolverState(u=u * cycle, f=f, u_lo=u * 0.5, cycle=cycle,
                             meta={"schedule": "abc", "tol": 1e-9})
            assert mgr.maybe_save(st)
        got = mgr.latest()
    assert got.cycle == 3
    np.testing.assert_array_equal(got.u, u * 3)
    np.testing.assert_array_equal(got.u_lo, u * 0.5)
    assert got.u_lo2 is None
    assert got.meta["schedule"] == "abc" and got.meta["tol"] == 1e-9


def test_async_save_commits(tmp_path, rng):
    u = rng.random((16, 128)).astype(np.float32)
    with OrbaxCheckpointManager(tmp_path / "ck", async_save=True) as mgr:
        mgr.maybe_save(SolverState(u=u, f=u, cycle=4, meta={}))
        mgr.wait_until_finished()
        got = mgr.latest()
    np.testing.assert_array_equal(got.u, u)


def test_refinement_resume_through_orbax(tmp_path):
    """Drop-in for the refinement loop's checkpoints= hook: interrupt a tw32
    solve, resume through the Orbax backend, reach the deep target."""
    from multigrid_poisson.refine import IterativeRefinementSolver

    n, tol = 65, 1e-13
    with OrbaxCheckpointManager(tmp_path / "ck", async_save=False) as mgr:
        s1 = IterativeRefinementSolver(PROBLEM, n, state="tw32")
        s1.max_cycles = 4
        rep1 = s1.solve(tol, checkpoints=mgr, checkpoint_chunk=4)
        assert rep1.rel_residual > tol
        saved = mgr.latest()
        assert saved is not None and saved.u_lo2 is not None

        s2 = IterativeRefinementSolver(PROBLEM, n, state="tw32")
        rep2 = s2.solve(tol, checkpoints=mgr, checkpoint_chunk=6)
    assert rep2.rel_residual <= tol


def test_refine3_resume_through_orbax(tmp_path):
    """The 3-D refinement loop accepts the Orbax backend too (same
    duck-typed latest/maybe_save contract, cubic padded arrays)."""
    from multigrid_poisson.models import poisson3d as p3
    from multigrid_poisson.refine3 import IterativeRefinement3

    n, tol = 33, 1e-11
    with OrbaxCheckpointManager(tmp_path / "ck3", async_save=False) as mgr:
        s1 = IterativeRefinement3(p3.REFERENCE_PROBLEM_3D, n, max_cycles=4,
                                  state="tw32")
        rep1 = s1.solve(tol, checkpoints=mgr, checkpoint_chunk=4)
        assert rep1.rel_residual > tol
        saved = mgr.latest()
        assert saved is not None and saved.u_lo2 is not None

        s2 = IterativeRefinement3(p3.REFERENCE_PROBLEM_3D, n, max_cycles=40,
                                  state="tw32")
        rep2 = s2.solve(tol, checkpoints=mgr, checkpoint_chunk=8)
    assert rep2.rel_residual <= tol
