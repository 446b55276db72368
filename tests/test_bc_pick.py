"""Closed data->train->eval loop: MPPI expert records, BC trains, eval
lifts (VERDICT r2 next #4). Scaled-down twin of
examples/13_bc_pick.run_pipeline; the full-size rates live in
tools/bench_suite.py bc_bench (GPU).

Slow tier: the expert's full-fidelity MPPI rollouts hit XLA:CPU's vmap
pathology (~50x slower per item than unbatched), so CI runs this nightly.
"""

import importlib

import numpy as np
import pytest


@pytest.mark.slow
def test_bc_pick_pipeline_end_to_end(tmp_path):
    mod = importlib.import_module("gym_kmanip_tpu.examples.13_bc_pick")
    expert_rate, bc_rate = mod.run_pipeline(
        n_episodes=3, ep_len=80, n_samples=128, n_train=1500, n_evals=4,
        data_dir=str(tmp_path), log=lambda *a: None,
    )
    # the MPPI expert must pick (the examples/8 verified recipe)
    assert expert_rate > 0, "expert never lifted the cube"
    # the cloned policy must reproduce the pick on fresh spawns
    assert bc_rate > 0, "BC policy never lifted the cube"
    # and the dataset must be ACT-layout readable (example 6's loader path)
    import glob

    import h5py

    files = sorted(glob.glob(str(tmp_path / "episode_*.hdf5")))
    assert len(files) == 3
    with h5py.File(files[0], "r") as f:
        assert "observations/qpos" in f and "action" in f
        assert "observations/cube_pose" in f
