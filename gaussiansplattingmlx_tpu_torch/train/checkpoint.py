"""Full training checkpoint: parameters, Adam state, step and counters, the
host RNG and the densify noise key, as one ``.npz`` (torch counterpart of
the JAX package's ``train/checkpoint.py``).

The files cross between the packages both ways: the array keys are the JAX
package's (``trainer.state_to_numpy``), ``config_json`` and
``host_rng_json`` are written and read as it writes and reads them, and the
densify noise key is its ``jax_key``, a threefry2x32 key as uint32[2]
(``utils/prng.py`` draws JAX's stream from it).  So a resumed run replays
the camera sequence and the densify noise whichever package wrote the file.
A typed JAX key also records ``jax_key_impl``; only threefry2x32 loads.
Port checkpoints written before the key was kept hold none, and load
without one.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..config import TrainConfig
from . import trainer as trainer_mod

THREEFRY = "threefry2x32"


def save(path, state, cfg: TrainConfig | None = None,
         host_rng: np.random.Generator | None = None, key=None) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = trainer_mod.state_to_numpy(state)
    if cfg is not None:
        arrays["config_json"] = np.frombuffer(cfg.to_json().encode("utf-8"), np.uint8)
    if host_rng is not None:
        rng_json = json.dumps(host_rng.bit_generator.state)
        arrays["host_rng_json"] = np.frombuffer(rng_json.encode("utf-8"), np.uint8)
    if key is not None:
        arrays["jax_key"] = np.asarray(key, np.uint32)
    np.savez(path, **arrays)


def load(path, device):
    """Returns (TrainState on ``device``, host_rng | None, key | None): the
    key as uint32[2], None when the file holds no ``jax_key``."""
    with np.load(path) as z:
        state = trainer_mod.state_from_numpy(z, device)
        host_rng = None
        if "host_rng_json" in z:
            host_rng = np.random.default_rng(0)
            host_rng.bit_generator.state = json.loads(
                bytes(z["host_rng_json"]).decode("utf-8"))
        key = None
        if "jax_key" in z:
            if "jax_key_impl" in z:
                impl = bytes(z["jax_key_impl"]).decode("utf-8")
                if impl != THREEFRY:
                    raise ValueError(f"{path}: jax_key is a {impl!r} key; only "
                                     f"{THREEFRY} keys load")
            key = np.asarray(z["jax_key"], np.uint32)
            if key.shape != (2,):
                raise ValueError(f"{path}: jax_key has shape {key.shape}, not a "
                                 f"{THREEFRY} key's (2,)")
    return state, host_rng, key


def load_config(path) -> TrainConfig | None:
    with np.load(path) as z:
        if "config_json" not in z:
            return None
        return TrainConfig.from_json(bytes(z["config_json"]).decode("utf-8"))
