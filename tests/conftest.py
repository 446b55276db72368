"""Test harness configuration.

Forces JAX onto a virtual 8-device CPU mesh (the standard fake-multihost
pattern) so sharding tests run without accelerator hardware. Must run
before any jax import. Tests that need a GPU carry the `gpu` marker and
skip here (the `gpu_device` fixture decides at run time).
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
# the `gpu` tier runs with JAX_PLATFORMS=cuda,cpu; everything else on the CPU
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

# Persistent compilation cache: the quick tier is compile-bound (every
# fused-solve/kernel test pays tens of seconds of XLA CPU compiles), and
# repeat runs hit the same programs. Local reruns reuse ~/.cache; CI
# restores it via actions/cache (see .github/workflows/python-app.yml).
_cache_dir = os.environ.get(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.expanduser("~"), ".cache", "kmanip_jax_cache"),
)
os.makedirs(_cache_dir, exist_ok=True)
jax.config.update("jax_compilation_cache_dir", _cache_dir)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
# CPU-backend compiles are cached only with this flag (XLA:CPU is
# otherwise excluded from the persistent cache)
jax.config.update("jax_persistent_cache_enable_xla_caches", "all")


# ---------------------------------------------------------------------------
# Test tiers. quick = -m "not slow and not mid" (target <20 min on 4 CPUs);
# mid = compile-heavy integration tests (>=50 s each, measured r5 — they run
# per-push in CI as their OWN parallel job, so coverage stays per-push);
# slow = training loops / full-res renders (nightly).
# Centralized here instead of scattering markers: the tier policy is a
# DURATIONS policy, and this list carries the measurements that set it.
# ---------------------------------------------------------------------------
import pytest  # noqa: E402

_MID_TESTS = (
    # nodeid substring            measured s (4-CPU host, r5)
    "test_parallel.py::test_sharded_ilqr_matches_single_device",   # 445
    "test_ik.py::test_ik_tracks_goal_sequence",                    # 264
    "test_parallel.py::test_graft_dryrun_multichip",               # 253
    "test_mpc.py::test_compiled_piece_caches",                     # 104
    "test_ik.py::test_ik_matches_scipy_trf",                       # 102
    "test_ik.py::test_ik_trf_tracks_scipy_sequence",               # 92
    "test_env.py::test_vision_env_smoke",                          # 75-88
    "test_ik.py::test_ik_vmap_batch",                              # 81
    "test_parallel.py::test_sharded_mppi_improves",                # 76
    "test_env_parity.py::test_env_trace_matches_reference",        # 60-69
    "test_mpc.py::test_mppi_improves_bad_nominal",                 # 68
    "test_dynamics.py::test_dual_and_torso_step",                  # 68
    "test_vec_env.py::test_vec_env_autoreset",                     # 63
    "test_vec_env.py::test_vec_env_vision_renders_batch",          # 63
    "test_env.py::test_env_checker[KManipDualArm]",                # 58
    "test_env.py::test_env_checker[KManipDualArmQPos]",            # 57
    "test_env.py::test_env_checker[KManipTorso]",                  # 55
    "test_env_parity.py::test_per_step_teacher_forced_parity",     # 51-56
    "test_dynamics.py::test_vmap_batch_matches_single",            # 50
    "test_parallel.py::test_sharded_matches_single_device_replay", # 50
)


def pytest_collection_modifyitems(config, items):
    for item in items:
        if any(frag in item.nodeid for frag in _MID_TESTS):
            item.add_marker(pytest.mark.mid)
