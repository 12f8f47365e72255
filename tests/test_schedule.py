"""Cycle-file parser and schedule-generator tests."""

import pathlib

import pytest

from multigrid_poisson.schedule import (
    Ascend,
    CoarseSolve,
    Descend,
    fmg,
    parse_cycle_file,
    parse_cycle_path,
    repeat,
    to_cycle_file,
    v_cycle,
    w_cycle,
)

SCHEDULES = pathlib.Path(__file__).resolve().parent.parent / "schedules"


def test_parse_two_grid_test_schedule():
    p = parse_cycle_path(SCHEDULES / "test.txt")
    assert (p.length, p.min_x, p.min_y) == (1.0, 0.0, 0.0)
    assert p.n_max == 16
    assert p.instructions == (
        Descend(next_n=8, steps=3),
        CoarseSolve(target_error=1e-8, option=1),
        Ascend(steps=3),
    )


def test_parse_vcycle_halving_levels():
    p = parse_cycle_path(SCHEDULES / "Vcycle.txt")
    descends = [i for i in p.instructions if isinstance(i, Descend)]
    assert [d.next_n for d in descends] == [128, 64, 32, 16, 8]
    assert all(d.steps == 3 for d in descends)
    ascends = [i for i in p.instructions if isinstance(i, Ascend)]
    assert len(ascends) == 5
    solves = [i for i in p.instructions if isinstance(i, CoarseSolve)]
    assert solves == [CoarseSolve(target_error=1e-7, option=1)]


def test_parse_trigger_schedule():
    p = parse_cycle_path(SCHEDULES / "VcycleTrigger.txt")
    # con_step = -1 → every smoothing node is trigger mode
    assert all(i.steps == -1 for i in p.instructions if isinstance(i, (Descend, Ascend)))


def test_parse_wcycle_shape():
    p = parse_cycle_path(SCHEDULES / "Wcycle.txt")
    kinds = ["D" if isinstance(i, Descend) else "S" if isinstance(i, CoarseSolve) else "A"
             for i in p.instructions]
    assert "".join(kinds) == "DDDSADSAADDSADSAAA"
    # level bookkeeping: the double-visited levels re-descend to the same sizes
    descends = [i.next_n for i in p.instructions if isinstance(i, Descend)]
    assert descends == [128, 64, 32, 32, 64, 32, 32]


def test_parse_con_step0_con_n0_explicit_tokens():
    text = """1.0 0.0 0.0
0 0
17 1
-1
2 9
0
1e-9 0
1
4
2
"""
    p = parse_cycle_file(text)
    assert p.instructions == (
        Descend(next_n=9, steps=2),
        CoarseSolve(target_error=1e-9, option=0),
        Ascend(steps=4),
    )


def test_parse_con_n2_decrement():
    text = "1.0 0.0 0.0\n1 2\n10 8\n-1\n-1\n0\n1e-8 1\n1\n1\n2\n"
    p = parse_cycle_file(text)
    descends = [i.next_n for i in p.instructions if isinstance(i, Descend)]
    assert descends == [9, 8]


def test_parse_rejects_descend_past_coarsest():
    text = "1.0 0.0 0.0\n3 1\n16 8\n-1\n-1\n2\n"  # 16 -> 8 -> (below N_min)
    with pytest.raises(ValueError, match="coarsest"):
        parse_cycle_file(text)


def test_validate_rejects_bad_ascend():
    text = "1.0 0.0 0.0\n3 1\n16 8\n1\n2\n"
    with pytest.raises(ValueError, match="Ascend"):
        parse_cycle_file(text)


def test_wcycle_generator_matches_bundled_shape():
    p = w_cycle(256, 32, steps=3)
    kinds = "".join("D" if isinstance(i, Descend) else "S" if isinstance(i, CoarseSolve)
                    else "A" for i in p.instructions)
    ref = parse_cycle_path(SCHEDULES / "Wcycle.txt")
    ref_kinds = "".join("D" if isinstance(i, Descend) else "S" if isinstance(i, CoarseSolve)
                        else "A" for i in ref.instructions)
    assert kinds == ref_kinds


def test_vcycle_generator_roundtrips_through_cycle_file():
    p = v_cycle(64, 8, steps=2, coarse_target=1e-9)
    p2 = parse_cycle_file(to_cycle_file(p))
    assert p2.instructions == p.instructions
    assert p2.n_max == p.n_max


def test_fmg_generator_structure():
    p = fmg(64, 8, steps=2)
    # descent phase: 0-step (restrict-RHS) descends down to the coarsest level
    descends = [i for i in p.instructions if isinstance(i, Descend)]
    n_levels = 4  # 64 -> 32 -> 16 -> 8
    assert all(d.steps == 0 for d in descends[: n_levels - 1])
    # refinement phase: smoothed V-cycle descends
    assert all(d.steps == 2 for d in descends[n_levels - 1:])
    ascends = [i for i in p.instructions if isinstance(i, Ascend)]
    assert all(a.steps == 2 for a in ascends)
    p.validate()


def test_repeat_chains_instructions():
    p = v_cycle(32, 8, steps=1)
    p3 = repeat(p, 3)
    assert len(p3.instructions) == 3 * len(p.instructions)
