"""Checkpoint/resume tests (utils.checkpoint + refinement integration)."""

import numpy as np
import pytest

import multigrid_poisson as mg
from multigrid_poisson.refine import IterativeRefinementSolver
from multigrid_poisson.utils.checkpoint import (
    CheckpointManager, SolverState, load_checkpoint, save_checkpoint,
)

PROBLEM = mg.REFERENCE_PROBLEM


def test_save_load_roundtrip(tmp_path, rng):
    u = rng.standard_normal((33, 33)).astype(np.float32)
    f = rng.standard_normal((33, 33)).astype(np.float32)
    lo = rng.standard_normal((33, 33)).astype(np.float32)
    path = tmp_path / "ck.npz"
    save_checkpoint(path, SolverState(u=u, f=f, u_lo=lo, cycle=7,
                                      meta={"schedule": "abc"}))
    back = load_checkpoint(path)
    np.testing.assert_array_equal(back.u, u)
    np.testing.assert_array_equal(back.f, f)
    np.testing.assert_array_equal(back.u_lo, lo)
    assert back.cycle == 7
    assert back.meta["schedule"] == "abc"


def test_manager_rotation_and_corruption_fallback(tmp_path, rng):
    mgr = CheckpointManager(tmp_path, every=1, keep=2)
    u = rng.standard_normal((9, 9)).astype(np.float32)
    for c in (1, 2, 3, 4):
        assert mgr.maybe_save(SolverState(u=u * c, f=u, cycle=c))
    files = mgr.existing()
    assert len(files) == 2                      # rotation keeps last 2
    # corrupt the newest: latest() must fall back to the older one
    files[-1].write_bytes(b"garbage")
    state = mgr.latest()
    assert state is not None and state.cycle == 3


def test_manager_cadence(tmp_path, rng):
    mgr = CheckpointManager(tmp_path, every=5, keep=10)
    u = rng.standard_normal((9, 9)).astype(np.float32)
    saved = [c for c in range(1, 21)
             if mgr.maybe_save(SolverState(u=u, f=u, cycle=c))]
    assert saved == [5, 10, 15, 20]


def test_refine_checkpoint_resume(tmp_path):
    """Interrupt a chunked refinement after the first chunk; resuming must
    reach the tolerance without redoing the completed cycles."""
    n, tol = 65, 1e-10
    solver = IterativeRefinementSolver(PROBLEM, n)

    mgr1 = CheckpointManager(tmp_path / "ck", every=1)
    # phase 1: cap at 3 cycles (simulated preemption), checkpoint every chunk
    solver.max_cycles = 3
    rep1 = solver.solve(tol, checkpoints=mgr1, checkpoint_chunk=3)
    assert rep1.cycles == 3 and rep1.rel_residual > tol
    assert mgr1.latest() is not None

    # phase 2: fresh solver instance (fresh process in real life), resume
    solver2 = IterativeRefinementSolver(PROBLEM, n)
    rep2 = solver2.solve(tol, checkpoints=mgr1, checkpoint_chunk=3)
    assert rep2.rel_residual <= tol
    # total = resumed-from-3 + additional; a from-scratch solve needs the sum
    fresh = IterativeRefinementSolver(PROBLEM, n).solve(tol)
    assert rep2.cycles >= fresh.cycles           # counter includes resumed base
    assert rep2.cycles - 3 < fresh.cycles        # but work after resume is less


def test_refine_checkpoint_ignores_mismatched_schedule(tmp_path):
    n = 65
    mgr = CheckpointManager(tmp_path / "ck", every=1)
    s1 = IterativeRefinementSolver(PROBLEM, n)
    s1.max_cycles = 2
    s1.solve(1e-10, checkpoints=mgr, checkpoint_chunk=2)
    # different schedule -> fingerprint mismatch -> start fresh (cycle count
    # equals its own work, not base + resumed)
    prog = mg.v_cycle(n, n_min=8, steps=2, coarse_option=0)
    s2 = IterativeRefinementSolver(PROBLEM, n, program=prog)
    s2.max_cycles = 2
    rep = s2.solve(1e-10, checkpoints=mgr, checkpoint_chunk=2)
    assert rep.cycles == 2
