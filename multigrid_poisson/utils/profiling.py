"""Profiling and observability helpers.

The reference's entire observability story is two wall-clocks and printf
narration (omp_get_wtime / cudaEvent around the whole cycle,
MG_solver_CPU.cpp:156,429-431; SURVEY.md §5). This module provides:

  * ``trace()`` — context manager around ``jax.profiler`` emitting a
    TensorBoard/Perfetto-loadable device trace;
  * ``time_call()`` — wall time of a jitted call: warm up (compile), then
    time repeated calls that each end in ``block_until_ready``;
  * ``HBM_BYTES_PER_S`` / ``hbm_bandwidth()`` — the published device-memory
    bandwidth per ``device_kind``; an unknown device is an error;
  * ``cost_report()`` — a static per-instruction cost model for a schedule:
    bytes moved, FLOPs, and bandwidth-bound time estimates per level, so
    measured cycle times have a first-principles comparison point.
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
import time
from typing import Callable, Optional

import jax

# Published device-memory bandwidth (bytes/s) by jax ``device_kind``.
# Source: NVIDIA H100 data sheet, SXM part (80 GB HBM3 at 3.35 TB/s).
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def hbm_bandwidth(device_kind: str) -> float:
    """Published memory bandwidth of ``device_kind``; raises for a device
    the table lacks rather than assuming a rate."""
    try:
        return HBM_BYTES_PER_S[device_kind]
    except KeyError:
        raise ValueError(
            f"no published memory bandwidth for device kind {device_kind!r}; "
            f"known: {sorted(HBM_BYTES_PER_S)}") from None


@contextlib.contextmanager
def trace(log_dir: str, host_tracer_level: int = 2):
    """``with trace(log_dir): run(...)`` → TensorBoard/Perfetto profile."""
    jax.profiler.start_trace(log_dir, host_tracer_level=host_tracer_level)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def time_call(fn: Callable, *args, reps: int = 5):
    """(median, min, max) wall seconds of ``fn(*args)`` over ``reps`` timed
    calls, after one untimed warm-up call that compiles. Each timed call
    waits for its result with ``block_until_ready``, so the time covers the
    device work, not just the enqueue."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), min(ts), max(ts)


# --- static cost model --------------------------------------------------------

@dataclasses.dataclass
class NodeCost:
    kind: str
    n: int
    hbm_bytes: int
    flops: int
    roofline_s: float


@dataclasses.dataclass
class CostReport:
    nodes: list[NodeCost]
    total_bytes: int
    total_flops: int
    roofline_s: float

    def summary(self) -> str:
        lines = [f"{'node':<14}{'N':>7}{'MB':>10}{'MFLOP':>10}{'us@bw':>10}"]
        for c in self.nodes:
            lines.append(f"{c.kind:<14}{c.n:>7}{c.hbm_bytes/1e6:>10.2f}"
                         f"{c.flops/1e6:>10.1f}{c.roofline_s*1e6:>10.1f}")
        lines.append(f"total: {self.total_bytes/1e6:.1f} MB, "
                     f"{self.total_flops/1e6:.1f} MFLOP, "
                     f"{self.roofline_s*1e3:.3f} ms at memory bandwidth")
        return "\n".join(lines)


def cost_report(program, device_kind: Optional[str] = None,
                hbm_bw: Optional[float] = None,
                dtype_bytes: int = 4) -> CostReport:
    """Static memory-traffic/FLOP estimate per schedule instruction.

    The bandwidth is ``hbm_bw`` when given, else the published rate of
    ``device_kind`` (``hbm_bandwidth``, an error for an unknown device).
    Smoothing moves one read of u and f and one write of u per sweep (one
    sweep per pass); restriction/prolongation assume the gather zoom (read
    src + write dst, two separable passes). Coarse solves are modeled as
    matmul FLOPs only.
    """
    from ..ops.layout import padded_shape
    from ..schedule import Ascend, CoarseSolve, Descend

    if hbm_bw is None:
        if device_kind is None:
            raise ValueError("cost_report needs hbm_bw or device_kind")
        hbm_bw = hbm_bandwidth(device_kind)

    nodes = []
    stack = [program.n_max]

    def level_bytes(n):
        rp, cp = padded_shape(n)
        return rp * cp * dtype_bytes

    def smooth_cost(n, steps):
        if steps <= 0:
            steps = 10  # trigger mode: a nominal count
        b = 3 * level_bytes(n) * steps
        fl = 8 * n * n * steps
        return b, fl

    for ins in program.instructions:
        n = stack[-1]
        if isinstance(ins, Descend):
            if ins.steps == 0:
                b, fl = 0, 0
            else:
                b, fl = smooth_cost(n, ins.steps)
            # residual + restrict
            b += int(3 * level_bytes(n) + 2 * level_bytes(ins.next_n)) * 2
            fl += 7 * n * n + 6 * ins.next_n * ins.next_n
            nodes.append(NodeCost("descend", n, b, fl, b / hbm_bw))
            stack.append(ins.next_n)
        elif isinstance(ins, CoarseSolve):
            fl = 2 * (n * n) ** 2 if ins.option == 0 else 100 * 10 * n * n
            b = 2 * level_bytes(n)
            nodes.append(NodeCost("coarse", n, b, fl, b / hbm_bw))
        elif isinstance(ins, Ascend):
            stack.pop()
            n = stack[-1]
            b = int(2 * level_bytes(n) * 2)
            fl = 6 * n * n
            if ins.steps != 0:
                sb, sf = smooth_cost(n, ins.steps)
                b += sb
                fl += sf
            nodes.append(NodeCost("ascend", n, b, fl, b / hbm_bw))

    tb = sum(c.hbm_bytes for c in nodes)
    tf = sum(c.flops for c in nodes)
    return CostReport(nodes=nodes, total_bytes=tb, total_flops=tf,
                      roofline_s=tb / hbm_bw)
