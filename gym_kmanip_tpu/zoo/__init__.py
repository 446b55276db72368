"""Policy zoo: shipped trained policies + save/load/eval API.

The reference stubs its learning loop (examples 6/7 are marked broken,
/root/reference/gym_kmanip/examples/6_train_from_dataset.py:1) and ships no
trained artifacts. This framework closes that gap: the zoo owns the policy
architectures, a pytree-npz artifact format (utils/checkpoint), and a
loader that returns a jitted `policy(SimState) -> ctrl` closure ready for
the closed-loop plant (dynamics.engine.make_control_step) or the Gym env.

Shipped artifacts (gym_kmanip_tpu/zoo/*.npz, trained in-repo by
tools/train_zoo.py / select_zoo.py / train_zoo_all.py /
train_zoo_pixels.py, eval'd closed-loop on the real plant over the spawn
range recorded in each artifact's meta — every meta carries its honest
eval protocol: episode count, seed, episode length, spawn range):

  * bc_pick_solo   — state BC MLP from the MPPI pick expert, FULL
    reference spawn range (20x20 cm).
  * bc_pick_dual   — dual-arm variant (per-arm-min expert cost sends the
    closest arm), full spawn range.
  * bc_pick_torso  — torso variant over the torso's MEASURED reachable
    band (y in [0.50, 0.54]; beyond it the arms physically cannot reach
    the cube — min tip-cube distance 0.15-0.21 m even under the expert).
  * bc_pixels_solo — end-to-end pixels policy (bc_pixels_cnn): the
    loader closure renders its own overhead frame on-device; the network
    never reads cube state.

Artifacts are small (a few MB) and versioned with the
architecture name, so a stale file fails loudly instead of mis-loading.
flax is required only to LOAD policies (the `train` extra), never by the
core package.
"""

import os
from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np

_ZOO_DIR = os.path.dirname(__file__)
_FORMAT_VERSION = 1


class PolicyArtifact(NamedTuple):
    params: Any          # flax params pytree
    stats: Dict[str, np.ndarray]  # input/output normalizers
    meta: Dict[str, Any]  # arch name, model name, training provenance


def _bc_mlp(out_dim: int, hidden: int = 256, depth: int = 2):
    """The BC policy architecture (examples/13_bc_pick.py trains this)."""
    from flax import linen as nn

    class BCMLP(nn.Module):
        @nn.compact
        def __call__(self, x):
            for _ in range(depth):
                x = nn.tanh(nn.Dense(hidden)(x))
            return nn.tanh(nn.Dense(out_dim)(x))

    return BCMLP()


def _bc_pixels_cnn(out_dim: int, hidden: int = 256):
    """Pixels BC policy (examples/15_bc_pixels.py trains this): overhead
    render -> conv stack, concatenated with proprioception (qpos, qvel;
    NO cube state — the cube is seen, not read), -> ctrl."""
    from flax import linen as nn

    import jax.numpy as jnp

    class BCPixelsCNN(nn.Module):
        @nn.compact
        def __call__(self, img, proprio):
            # img: (B, H, W, 3) float in [0, 1]; proprio: (B, P)
            x = img
            for feat in (16, 32, 64):
                x = nn.relu(nn.Conv(feat, (3, 3), strides=(2, 2))(x))
            x = x.reshape((x.shape[0], -1))
            x = nn.relu(nn.Dense(hidden)(x))
            x = jnp.concatenate([x, proprio], axis=-1)
            x = nn.tanh(nn.Dense(hidden)(x))
            return nn.tanh(nn.Dense(out_dim)(x))

    return BCPixelsCNN()


_ARCHS = {"bc_mlp": _bc_mlp, "bc_pixels_cnn": _bc_pixels_cnn}


def _flatten_params(tree, prefix="p:"):
    """flax params are nested dicts of arrays -> flat {keypath: array}."""
    out = {}
    for key, v in tree.items():
        kp = f"{prefix}{key}"
        if isinstance(v, dict):
            out.update(_flatten_params(v, prefix=f"{kp}/"))
        else:
            out[kp] = np.asarray(v)
    return out


def _unflatten_params(flat: Dict[str, np.ndarray]):
    tree: Dict[str, Any] = {}
    for kp, arr in flat.items():
        parts = kp.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def save_policy(path: str, params, stats: Dict[str, np.ndarray],
                meta: Dict[str, Any]) -> None:
    """Template-free npz artifact: params leaves stored under their
    keypaths, stats under s:, meta as a json scalar — so load_policy can
    rebuild the pytree without a structure template (unlike the generic
    utils/checkpoint format, which restores INTO a template)."""
    import json as _json

    assert meta.get("arch") in _ARCHS, f"unknown arch {meta.get('arch')}"
    arrays = _flatten_params(params)
    for key, v in stats.items():
        arrays[f"s:{key}"] = np.asarray(v)
    arrays["meta"] = np.asarray(
        _json.dumps({**meta, "format_version": _FORMAT_VERSION})
    )
    tmp = f"{path}.tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def list_policies() -> Tuple[str, ...]:
    return tuple(
        sorted(
            f[: -len(".npz")]
            for f in os.listdir(_ZOO_DIR)
            if f.endswith(".npz")
        )
    )


def load_artifact(name_or_path: str) -> PolicyArtifact:
    path = name_or_path
    if not os.path.exists(path):
        path = os.path.join(_ZOO_DIR, f"{name_or_path}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no policy '{name_or_path}' (shipped: {list_policies()})"
        )
    import json as _json

    with np.load(path) as data:
        meta = _json.loads(str(data["meta"]))
        stats = {
            key[2:]: data[key] for key in data.files if key.startswith("s:")
        }
        params = _unflatten_params(
            {key[2:]: data[key] for key in data.files if key.startswith("p:")}
        )
    if int(meta.get("format_version", -1)) != _FORMAT_VERSION:
        raise ValueError(
            f"policy artifact format {meta.get('format_version')} != "
            f"{_FORMAT_VERSION} (re-train with tools/train_zoo.py)"
        )
    return PolicyArtifact(params, stats, meta)


def load_policy(name_or_path: str) -> Tuple[Callable, Dict[str, Any]]:
    """(jitted policy(SimState) -> ctrl, meta) for a zoo artifact.

    The closure reproduces examples/13_bc_pick.py's deployment math:
    normalized (qpos, qvel, cube_pose) in, tanh output rescaled to the
    actuator ctrl_range.
    """
    import jax
    import jax.numpy as jnp

    from gym_kmanip_tpu.models import get_model

    art = load_artifact(name_or_path)
    meta = dict(art.meta)
    model = get_model(str(meta["model"]))
    arch = str(meta["arch"])
    kw = dict(hidden=int(meta.get("hidden", 256)))
    if arch == "bc_mlp":
        kw["depth"] = int(meta.get("depth", 2))
    net = _ARCHS[arch](out_dim=model.nu, **kw)
    # numpy normalizers: baked into the jitted program as literals (device
    # arrays in closures become hidden program inputs,
    # tests/test_no_device_closures.py)
    mu = np.asarray(art.stats["mu"], np.float32)
    sd = np.asarray(art.stats["sd"], np.float32)
    mid = np.asarray(art.stats["mid"], np.float32)
    half = np.asarray(art.stats["half"], np.float32)
    params = art.params

    if arch == "bc_pixels_cnn":
        # self-contained pixels policy: the closure RENDERS its own
        # observation with the on-device raycaster — it reads qpos/qvel
        # (proprioception) and PIXELS, never the cube state
        from gym_kmanip_tpu.render.raycast import render_camera

        cam = str(meta["cam"])
        h, w = int(meta["img_h"]), int(meta["img_w"])

        def policy(state) -> "jax.Array":
            img = render_camera(
                model, cam, state.qpos, state.cube_pos, state.cube_quat,
                h, w,
            ).astype(jnp.float32) / 255.0
            proprio = jnp.concatenate([state.qpos, state.qvel])
            pn = (proprio - mu) / sd
            yn = net.apply(params, img[None], pn[None])[0]
            return yn * half + mid

        return jax.jit(policy), meta

    def policy(state) -> "jax.Array":
        x = jnp.concatenate(
            [state.qpos, state.qvel, state.cube_pos, state.cube_quat]
        )
        xn = (x - mu) / sd
        yn = net.apply(params, xn[None])[0]
        return yn * half + mid

    return jax.jit(policy), meta
