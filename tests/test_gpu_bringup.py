"""What running on the GPU requires of the repo, checked on the CPU.

- the main path imports with none of the optional packages;
- no module carries code for a TPU;
- the compile cache follows JAX_COMPILATION_CACHE_DIR, else `.jax_cache/`
  in the checkout;
- chip_smoke.py refuses a CPU backend, and its phases pass on the CPU at
  tiny sizes (the full sizes run on the card: `python chip_smoke.py`).

Tests that need the card carry the `gpu` marker and skip here; run them on
a GPU machine with `JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`.
"""

import ast
import importlib
import os
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "gym_kmanip_tpu")


def _chip_smoke():
    sys.path.insert(0, REPO)
    return importlib.import_module("chip_smoke")


def _child_env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)
    env.update(extra)
    return env


_BLOCKED_IMPORTS = r"""
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("gymnasium", "flax", "h5py", "imageio"):
            raise ImportError(f"{name} is blocked")

sys.meta_path.insert(0, Block())
import gym_kmanip_tpu
from gym_kmanip_tpu.dynamics import init_state
from gym_kmanip_tpu.dynamics.engine import make_control_step
from gym_kmanip_tpu.models import get_model
from gym_kmanip_tpu.mpc.cost import make_ee_tracking_cost_ilqr
from gym_kmanip_tpu.mpc.mppi import make_mppi_solver
from gym_kmanip_tpu.parallel.mesh import make_sharded_ilqr_solver
from gym_kmanip_tpu.solvers.ilqr import make_ilqr_solver
import chip_smoke
print("imported")
"""


def test_main_path_imports_without_optional_packages():
    """The GPU machine is only sure to have JAX, numpy, scipy, optax, chex
    and einops: gymnasium, flax, h5py and imageio stay off the main path."""
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORTS], capture_output=True,
        text=True, timeout=120, env=_child_env(), cwd=REPO,
    )
    assert out.returncode == 0 and "imported" in out.stdout, out.stderr[-2000:]


def _tpu_findings(path):
    tree = ast.parse(open(path).read(), path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names]
            mod = getattr(node, "module", None) or ""
            if "pallas.tpu" in mod or any("pallas.tpu" in n for n in names) or (
                mod.endswith("pallas") and "tpu" in names
            ):
                found.append(f"{path}:{node.lineno} imports the TPU Pallas API")
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            if node.value.lower() == "tpu" or node.value.startswith("TPU v"):
                found.append(f"{path}:{node.lineno} keys on {node.value!r}")
    return found


def test_no_module_carries_tpu_code():
    """No import of the TPU Pallas API, and no branch on a TPU backend or
    device kind, anywhere in the package or the repo's scripts."""
    paths = [os.path.join(REPO, f) for f in ("bench.py", "chip_smoke.py")]
    for root in (PKG, os.path.join(REPO, "tools")):
        for d, _, files in os.walk(root):
            paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    findings = [f for p in paths for f in _tpu_findings(p)]
    assert not findings, findings


@pytest.mark.parametrize("env_set", [True, False], ids=["env_set", "env_unset"])
def test_compile_cache_dir_rule(env_set, tmp_path):
    code = (
        "import jax\n"
        "from gym_kmanip_tpu.utils.compile_cache import enable_compile_cache\n"
        "print(enable_compile_cache())\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
    )
    extra = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if env_set else {}
    env = _child_env(**extra)
    if not env_set:
        env.pop("JAX_COMPILATION_CACHE_DIR", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    returned, configured = out.stdout.split()[-2:]
    want = str(tmp_path) if env_set else os.path.join(REPO, ".jax_cache")
    assert returned == want and configured == want


def test_chip_smoke_refuses_a_cpu_backend():
    """No CPU fallback: without a GPU the script exits nonzero and prints
    no result line."""
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")], capture_output=True,
        text=True, timeout=120, env=_child_env(), cwd=REPO,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "not 'gpu'" in out.stderr


def test_chip_smoke_dynamics_phase_tiny():
    cs = _chip_smoke()
    # the 2 ms regime is covered by tests/test_precision.py
    cs.run_phase(cs.phase_dynamics, K=4, robots=("solo_arm",), regimes=cs.REGIMES[1:])


def test_chip_smoke_golden_phase():
    cs = _chip_smoke()
    cs.run_phase(cs.phase_golden)


def test_chip_smoke_mppi_phase_tiny():
    cs = _chip_smoke()
    cs.run_phase(cs.phase_mppi, K=8, H=2, n_steps=2, require_lift=False)


def test_chip_smoke_ilqr_phase_tiny():
    from test_mpc import _tiny_model

    cs = _chip_smoke()
    cs.run_phase(cs.phase_ilqr, model=_tiny_model(), H=8, n_iters=4, reps=1,
                 ref_iters=2, goal_offset=(0.05, 0.0, -0.05))


def test_chip_smoke_four_mppi_phase_tiny():
    """The sharded MPPI solve over four of the virtual CPU devices
    (tests/conftest.py) against its one-device replay."""
    cs = _chip_smoke()
    cs.run_phase(cs.phase_four_mppi, local_k=4, H=2)


def test_chip_smoke_four_ilqr_phase_tiny():
    from test_mpc import _tiny_model

    cs = _chip_smoke()
    cs.run_phase(cs.phase_four_ilqr, model=_tiny_model(), B=8, H=6, n_iters=3)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: decided when the test runs, never at
    import, so every worker collects the same tests."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run on the card with -m gpu)")
    return jax.devices()[0]


@pytest.mark.gpu
def test_substep_on_gpu_matches_cpu(gpu_device):
    cs = _chip_smoke()
    cs.run_phase(cs.phase_dynamics, K=64)
    cs.run_phase(cs.phase_golden)
    assert gpu_device.platform == "gpu"
