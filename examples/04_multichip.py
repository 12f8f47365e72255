"""Multi-device execution on a device mesh (demo runs on 8 virtual CPU devices).

Without the platform/device-count overrides the same code row-partitions
across the GPUs of a host (and across hosts via parallel.multihost).

    python examples/04_multichip.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import multigrid_poisson as mg  # noqa: E402
from multigrid_poisson.parallel import multihost  # noqa: E402
from multigrid_poisson.parallel.mesh import (  # noqa: E402
    ShardingPolicy, make_mesh,
)


def main():
    # 1-D row partition: fine levels sharded, coarse levels replicated
    mesh = make_mesh()
    policy = ShardingPolicy(mesh, threshold_rows=16)
    program = mg.v_cycle(257, n_min=8, steps=3)
    cc = mg.compile_program(program, mg.REFERENCE_PROBLEM, policy=policy,
                            donate=False)
    u, f = cc.init()
    u, err = cc(u, f)
    print(f"row-sharded over {len(jax.devices())} devices: "
          f"finest smoothing error {float(err):.3e}")

    # 2-D block partition (the multi-host layout)
    mesh2 = multihost.hybrid_block_mesh()
    policy2 = multihost.block_policy(mesh2, threshold_rows=16)
    cc2 = mg.compile_program(program, mg.REFERENCE_PROBLEM, policy=policy2,
                             donate=False)
    u2, f2 = cc2.init()
    u2, err2 = cc2(u2, f2)
    print(f"block-sharded on mesh {dict(mesh2.shape)}: "
          f"finest smoothing error {float(err2):.3e}")

    # deep solve, sharded
    rep = mg.solve_to_tolerance(mg.REFERENCE_PROBLEM, 257, tol=1e-9,
                                policy=policy)
    print(f"sharded refinement: {rep.rel_residual:.3e} in {rep.cycles} cycles")


if __name__ == "__main__":
    main()
