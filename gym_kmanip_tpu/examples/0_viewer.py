"""Viewer example: live interactive browser viewer, or offline frames.

JAX analog of the reference viewer example
(/root/reference/gym_kmanip/examples/0_viewer.py), which launches the
dm_control GUI. Headless accelerator hosts have no GUI, so:

  * `python 0_viewer.py --live` serves a LIVE interactive viewer over
    HTTP (gym_kmanip_tpu/viewer.py): frames from the on-device raycaster
    in any browser, keyboard teleop (WASD/QE moves the EE, space grips,
    R resets) — the functional equivalent of dm_control.viewer.launch.
  * without --live it rolls a random policy and writes PNG frames / mp4.

Choose the env by editing ENV_NAME (same convention as the reference
examples, e.g. examples/1_control.py:9-17).
"""

import os
import sys

import gymnasium as gym
import numpy as np

import gym_kmanip_tpu  # noqa: F401

ENV_NAME: str = "KManipSoloArm"
# ENV_NAME: str = "KManipSoloArmQPos"
# ENV_NAME: str = "KManipDualArm"
# ENV_NAME: str = "KManipDualArmQPos"
# ENV_NAME: str = "KManipTorso"
NUM_STEPS: int = 16
OUT_DIR: str = "/tmp/kmanip_viewer"


def main():
    if "--live" in sys.argv:
        from gym_kmanip_tpu.viewer import LiveViewer

        env = gym.make(ENV_NAME)
        LiveViewer(env).run()
        env.close()
        return

    env = gym.make(ENV_NAME)
    env.reset(seed=0)
    os.makedirs(OUT_DIR, exist_ok=True)
    frames = []
    for i in range(NUM_STEPS):
        action = env.action_space.sample()
        obs, reward, terminated, truncated, info = env.step(action)
        frame = env.render()
        frames.append(frame)
        print(f"step {i}: reward={reward:.4f}")
    try:
        import imageio

        try:
            imageio.mimsave(os.path.join(OUT_DIR, "viewer.mp4"), frames, fps=30)
            print(f"wrote {OUT_DIR}/viewer.mp4")
        except Exception:
            imageio.mimsave(os.path.join(OUT_DIR, "viewer.gif"), frames, fps=25, loop=0)
            print(f"no ffmpeg backend; wrote {OUT_DIR}/viewer.gif")
    except ImportError:
        for i, f in enumerate(frames):
            np.save(os.path.join(OUT_DIR, f"frame_{i:03d}.npy"), f)
        print(f"imageio unavailable; wrote npy frames to {OUT_DIR}")
    env.close()


if __name__ == "__main__":
    main()
