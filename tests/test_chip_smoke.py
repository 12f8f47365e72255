"""chip_smoke.py rehearsed on the CPU: every phase at a tiny size, the
refusal to run without a GPU, and the pieces of its output contract.

The phases are the same functions the script runs on the card at the
BASELINE sizes; here they take small ones. Also covered: the compile-cache
location helper the entry points share, and the CLI's platform choices.
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _all_ok(results):
    assert results and all(r["ok"] for r in results), results


def test_phase_cli(cs):
    _all_ok(cs.phase_cli())


def test_phase_vcycle(cs):
    _all_ok(cs.phase_vcycle(n=129, cycles=4, smooth_n=129, smooth_sweeps=5))


def test_phase_trigger(cs):
    _all_ok(cs.phase_trigger(n=65))


def test_phase_fmg(cs):
    _all_ok(cs.phase_fmg(n=129))


def test_phase_deep(cs):
    _all_ok(cs.phase_deep(n=129, f64_n=65))


def test_phase_3d(cs):
    _all_ok(cs.phase_3d(n=17, check_n=17, cycles=2))


def test_phase_four_cards(cs):
    _all_ok(cs.phase_four_cards(n2=129, n_fmg=65, n3=33,
                                devices=jax.devices()[:4]))


def test_main_refuses_cpu(cs, capsys):
    with pytest.raises(SystemExit) as exc:
        cs.main([])
    assert "needs a GPU" in str(exc.value.code)
    assert '"ok"' not in capsys.readouterr().out


def _env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


def test_script_exits_nonzero_without_gpu():
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env=_env())
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_script_alone_exits_nonzero(tmp_path):
    """Copied into a directory without the package, the script fails and
    prints no result."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = _env()
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path, env=env)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


@pytest.mark.parametrize("text,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W",
     [("NVIDIA H100 80GB HBM3", "700.00 W")]),
    ("NVIDIA H100 80GB HBM3, 500.00 W\nNVIDIA H100 80GB HBM3, 700.00 W\n",
     [("NVIDIA H100 80GB HBM3", "500.00 W"),
      ("NVIDIA H100 80GB HBM3", "700.00 W")]),
])
def test_parse_smi(cs, text, want):
    assert cs.parse_smi(text) == want


def test_parse_smi_rejects_garbage(cs):
    with pytest.raises(ValueError):
        cs.parse_smi("no comma here")


def test_device_line_is_the_contract_json(cs):
    line = cs.device_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


@pytest.mark.parametrize("got,ok,how", [
    ("0.100000,0.200000\n", True, "byte-equal"),
    ("0.100001,0.200000\n", True, "1 of 2 values"),
    ("0.100002,0.200000\n", False, "1 of 2 values"),
])
def test_compare_csv(cs, got, ok, how):
    res_ok, _, res_how = cs.compare_csv(got, "0.100000,0.200000\n")
    assert res_ok is ok and res_how.startswith(how)


def _cache_dir(env):
    code = ("from multigrid_poisson.utils.compile_cache import "
            "enable_compile_cache; import jax; d = enable_compile_cache(); "
            "print(d); print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT, env=env,
                         check=True).stdout.split()
    return out


def test_compile_cache_defaults_to_repo_dir():
    env = _env()
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    used, configured = _cache_dir(env)
    assert used == configured == str(ROOT / ".jax_cache")


def test_compile_cache_follows_env(tmp_path):
    env = dict(_env(), JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cc"))
    used, configured = _cache_dir(env)
    assert used == configured == str(tmp_path / "cc")


def test_cli_platform_choices():
    from multigrid_poisson.cli import build_parser

    parser = build_parser()
    args = parser.parse_args(["1", "x.txt", "--platform", "gpu"])
    assert args.platform == "gpu"
    assert parser._option_string_actions["--platform"].choices == [
        "auto", "cpu", "gpu"]


@pytest.mark.parametrize("flag", [
    ["--platform", "cuda"], ["--kernels", "pallas"], ["--halo", "rdma"],
    ["--trigger-batch", "4"],
])
def test_cli_rejects_removed_options(flag):
    from multigrid_poisson.cli import build_parser

    with pytest.raises(SystemExit):
        build_parser().parse_args(["1", "x.txt", *flag])


@pytest.mark.parametrize("field", ["kernels", "halo", "trigger_batch"])
def test_solver_config_has_no_kernel_options(field):
    import multigrid_poisson as mg

    with pytest.raises(TypeError):
        mg.SolverConfig(**{field: None})
