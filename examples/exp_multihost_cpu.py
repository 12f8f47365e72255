"""REAL multi-process execution of the multihost layer (CPU, localhost).

The reference is single-process/single-device (cudaSetDevice(0),
MG_solver_GPU.cu:58); `parallel.multihost` is the hosts x devices entry
this framework adds. Until this harness it had only mocked coverage —
this script actually runs `jax.distributed.initialize` across N local
processes (gloo-backed coordination over localhost), builds
`multihost.hybrid_block_mesh()` in each (hosts ride the row axis, local
devices the col axis), compiles one block-sharded V-cycle over
the GLOBAL mesh, executes it, and bit-compares the solution against a
single-process run of the SAME worker on the same logical 2x2 mesh.

Usage:
  python examples/exp_multihost_cpu.py                  # launcher
  python examples/exp_multihost_cpu.py --pid I --nproc N --port P --out F
                                                        # worker (internal)

The launcher runs the worker twice: once as 1 process x 4 virtual CPU
devices (single-host branch of hybrid_block_mesh -> 2x2 mesh) and once as
2 processes x 2 devices (multi-host branch, process_is_granule -> 2x2
mesh). Same logical mesh + same GSPMD program => outputs must bit-match.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
N = 129


def worker(pid: int, nproc: int, port: int, out: str, local_devs: int):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    sys.path.insert(0, str(REPO))
    import multigrid_poisson as mg
    from multigrid_poisson.compiled import compile_program
    from multigrid_poisson.parallel import multihost

    multihost.initialize(f"127.0.0.1:{port}", num_processes=nproc,
                         process_id=pid)
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.local_device_count() == local_devs
    assert len(jax.devices()) == nproc * local_devs

    mesh = multihost.hybrid_block_mesh()
    assert dict(mesh.shape) == {"rows": 2, "cols": 2}, mesh.shape
    policy = multihost.block_policy(mesh, threshold_rows=8)
    assert policy.is_sharded(N)

    program = mg.v_cycle(N, n_min=8, steps=3, coarse_target=1e-7)
    cc = compile_program(program, mg.REFERENCE_PROBLEM, policy=policy,
                         donate=False)
    u0, f0 = cc.init()
    u, err = cc(u0, f0)

    # replicate, then every process holds the full solution locally
    rep = jax.jit(lambda x: x[:N, :N],
                  out_shardings=NamedSharding(mesh, P()))(u)
    sol = np.asarray(jax.device_get(rep.addressable_data(0)))

    # --- 3-D: the z-plane-sharded cycle over ALL devices (a 1-D ring that
    # --- CROSSES the process boundary — each process owns half the z
    # --- planes; GSPMD kernels, real inter-process collectives)
    from multigrid_poisson.compiled3 import compile_program3
    from multigrid_poisson.models import poisson3d as p3
    from multigrid_poisson.parallel.mesh import ZShardingPolicy3, make_mesh_z
    from multigrid_poisson.solver import SolverConfig

    n3 = 65
    mesh_z = make_mesh_z(jax.devices())
    zpol = ZShardingPolicy3(mesh_z, threshold_planes=8)
    assert zpol.is_sharded(n3)
    prog3 = mg.v_cycle(n3, n_min=5, steps=3, coarse_target=1e-8, coarsen=3)
    with mesh_z:
        cc3 = compile_program3(prog3, p3.REFERENCE_PROBLEM_3D,
                               SolverConfig(omega=6.0 / 7.0,
                                            collect_node_stats=False),
                               policy=zpol)
        u3, f3 = cc3.init()
        o3, err3 = cc3(u3, f3)
    rep3 = jax.jit(lambda x: x,
                   out_shardings=NamedSharding(mesh_z, P()))(o3)
    sol3 = np.asarray(jax.device_get(rep3.addressable_data(0)))

    if pid == 0:
        np.savez(out, sol=sol, err=float(err), sol3=sol3,
                 err3=float(err3))
    # rendezvous so the coordinator does not tear down before savez
    from jax.experimental import multihost_utils
    multihost_utils.sync_global_devices("exp_multihost_cpu_done")
    print(f"[worker {pid}/{nproc}] err={float(err):.6e} ok", flush=True)


def launch(nproc: int, local_devs: int, port: int, out: str):
    env = dict(os.environ)
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={local_devs}")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--pid", str(i), "--nproc", str(nproc),
         "--port", str(port), "--out", out, "--local-devs", str(local_devs)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(nproc)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for i, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(o)
            raise RuntimeError(f"worker {i} exited {p.returncode}")
    return outs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pid", type=int, default=None)
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--port", type=int, default=19677)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--local-devs", type=int, default=2)
    a = ap.parse_args()
    if a.pid is not None:
        worker(a.pid, a.nproc, a.port, a.out, a.local_devs)
        return

    import numpy as np

    with tempfile.TemporaryDirectory() as td:
        ref, multi = f"{td}/ref.npz", f"{td}/multi.npz"
        print("[launcher] 1 process x 4 devices (single-host 2x2 mesh)...",
              flush=True)
        launch(1, 4, a.port, ref)
        print("[launcher] 2 processes x 2 devices (hosts x devices 2x2 mesh)...",
              flush=True)
        launch(2, 2, a.port + 1, multi)
        r, m = np.load(ref), np.load(multi)
        md = float(np.max(np.abs(r["sol"] - m["sol"])))
        de = abs(float(r["err"]) - float(m["err"]))
        md3 = float(np.max(np.abs(r["sol3"] - m["sol3"])))
        de3 = abs(float(r["err3"]) - float(m["err3"]))
        print(json.dumps({"maxdiff_sol": md, "diff_err": de,
                          "err": float(m["err"]),
                          "maxdiff_sol3": md3, "diff_err3": de3,
                          "err3": float(m["err3"])}), flush=True)
        assert md == 0.0 and de == 0.0, (md, de)
        assert md3 == 0.0 and de3 == 0.0, (md3, de3)
        print("[launcher] MULTI-PROCESS RUN BIT-MATCHES SINGLE-PROCESS",
              flush=True)


if __name__ == "__main__":
    main()
