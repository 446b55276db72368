"""VR teleoperation via Vuer/WebXR.

Analog of /root/reference/gym_kmanip/examples/4_teleop.py: a Vuer app
streams hand tracking at ~30 fps, the gesture mapping in
gym_kmanip_tpu.teleop turns it into EE/grip actions (both hands for
bimanual morphologies, orientation from the wrist rotation matrix, gripper
from the thumb-middle pinch distance, thumb-pinky reset with a 1 s
backoff), and the session loop steps the env and upserts the scene (URDF
robot with live joint values, cube, table plane, hand spheres) at ~60 fps.

vuer is an optional dependency (not shipped in training images); this module
stays importable without it (the pure gesture logic lives in
gym_kmanip_tpu.teleop and is tested in tests/test_teleop.py; THIS wiring —
handlers, lock discipline, session loop, scene upserts — is exercised by
tests/test_teleop.py's recorded-session replay against a mock Vuer). Run,
then open the printed URL in a WebXR browser/headset (the reference README
tunnels it with ngrok, README.md:118-124).
"""

import asyncio
import time

import gymnasium as gym
import numpy as np

import gym_kmanip_tpu  # noqa: F401  (registers env ids)
from gym_kmanip_tpu import teleop as tp

try:
    from vuer import Vuer, VuerSession  # noqa: F401
    from vuer.schemas import Box, Hands, Plane, PointLight, Sphere, Urdf

    HAS_VUER = True
except ImportError:
    HAS_VUER = False

# choose your environment (any of the 8 registered ids)
ENV_NAME: str = "KManipSoloArm"

# Vuer needs a web link to the URDF for the headset (reference
# 4_teleop.py:45-47 points at the kscalelabs/webstompy mirror)
URDF_WEB_BASE: str = (
    "https://raw.githubusercontent.com/kscalelabs/webstompy/master/urdf"
)


def _upsert(session, schemas, item: dict) -> None:
    kwargs = {kk: v for kk, v in item.items() if kk != "schema"}
    session.upsert(schemas[item["schema"]](**kwargs), to="bgChildren")


def build_app(env, app, schemas, clock=time.time, log=print):
    """Wire the Vuer app: HAND_MOVE handler + the env/scene session loop.

    `app` must provide the Vuer decorator surface (add_handler/spawn) and
    `schemas` the schema constructors — injected so a mock Vuer can replay
    recorded hand frames in tests exactly through this code path.
    Returns the TeleopState (handy for assertions).
    """
    bimanual = "eel_pos" in env.action_space.spaces
    teleop = tp.TeleopState(bimanual=bimanual)
    lock = asyncio.Lock()
    last_reset = [clock()]

    @app.add_handler("HAND_MOVE")
    async def hand_handler(event, _):
        async with lock:
            teleop.handle(event.value)

    async def run_env() -> None:
        async with lock:
            action = teleop.action()
            do_reset = teleop.consume_reset(clock(), last_reset[0])
        start = clock()
        env.step(action)
        log(f"env step took {(clock() - start) * 1000:.2f}ms")
        if do_reset:
            log("environment reset")
            env.reset()
            last_reset[0] = clock()

    @app.spawn(start=True)
    async def session_loop(session):
        src = f"{URDF_WEB_BASE}/{env.unwrapped.urdf_filename}"
        for item in tp.scene_static(env, src):
            _upsert(session, schemas, item)
        await asyncio.sleep(0.01)
        while True:
            await asyncio.gather(run_env(), asyncio.sleep(1 / tp.MAX_FPS))
            async with lock:
                for item in tp.scene_dynamic(env, teleop):
                    _upsert(session, schemas, item)

    return teleop


def main():
    if not HAS_VUER:
        raise SystemExit(
            "vuer is not installed in this image; `pip install vuer` on a "
            "machine with network access to run VR teleop."
        )
    schemas = dict(
        Box=Box, Hands=Hands, Plane=Plane, PointLight=PointLight,
        Sphere=Sphere, Urdf=Urdf,
    )
    env = gym.make(ENV_NAME)
    env.reset(seed=0)
    build_app(env, Vuer(), schemas)  # Vuer's spawn(start=True) blocks


if __name__ == "__main__":
    main()
