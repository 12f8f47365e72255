"""Profiling helpers + sharded-refinement integration tests."""

import numpy as np

import multigrid_poisson as mg
from multigrid_poisson.parallel.mesh import ShardingPolicy, make_mesh
from multigrid_poisson.refine import solve_to_tolerance
from multigrid_poisson.utils.profiling import cost_report

H100 = "NVIDIA H100 80GB HBM3"


def test_cost_report_structure():
    prog = mg.v_cycle(257, n_min=8, steps=3)
    rep = cost_report(prog, device_kind=H100)
    assert len(rep.nodes) == len(prog.instructions)
    assert rep.total_bytes > 0 and rep.total_flops > 0
    # finest-level descend dominates traffic
    descend_bytes = [c.hbm_bytes for c in rep.nodes if c.kind == "descend"]
    assert descend_bytes[0] == max(descend_bytes)
    assert "total:" in rep.summary()


def test_cost_report_fmg_descend_is_cheap():
    prog = mg.fmg(65, n_min=8, steps=2)
    rep = cost_report(prog, device_kind=H100)
    fmg_descends = [c for c in rep.nodes[:3] if c.kind == "descend"]
    smoothed = [c for c in rep.nodes if c.kind == "descend"
                and c.n == 65 and c.hbm_bytes > fmg_descends[0].hbm_bytes]
    assert smoothed  # later smoothing descends cost more than FMG descents


def test_refine_sharded_matches_single_device():
    """Refinement with a GSPMD sharding policy on the 8-device CPU mesh must
    converge identically (the whole while_loop is sharded)."""
    mesh = make_mesh()
    policy = ShardingPolicy(mesh, threshold_rows=8)
    single = solve_to_tolerance(mg.REFERENCE_PROBLEM, 129, tol=1e-9)
    sharded = solve_to_tolerance(mg.REFERENCE_PROBLEM, 129, tol=1e-9,
                                 policy=policy)
    assert sharded.rel_residual <= 1e-9
    assert abs(sharded.cycles - single.cycles) <= 1
    np.testing.assert_allclose(np.asarray(sharded.u), np.asarray(single.u),
                               rtol=1e-5, atol=1e-7)
