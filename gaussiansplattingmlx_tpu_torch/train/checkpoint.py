"""Full training checkpoint: parameters, Adam state, step and counters, the
host RNG and the densify noise generator, as one ``.npz`` (torch
counterpart of the JAX package's ``train/checkpoint.py``).

The files cross between the packages: the array keys are the JAX
package's (``trainer.state_to_numpy``), and ``config_json`` and
``host_rng_json`` are written and read as it writes and reads them, so a
resumed run replays the camera sequence whichever package wrote the file.
The densify noise does not cross: the JAX package keeps a PRNG key
(``jax_key``), which the port ignores, and the port keeps its
``torch.Generator`` state under ``torch_generator_state``, which the JAX
package ignores.  Within the port a resume is bit-exact.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..config import TrainConfig
from . import trainer as trainer_mod


def save(path, state, cfg: TrainConfig | None = None,
         host_rng: np.random.Generator | None = None,
         generator: torch.Generator | None = None) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = trainer_mod.state_to_numpy(state)
    if cfg is not None:
        arrays["config_json"] = np.frombuffer(cfg.to_json().encode("utf-8"), np.uint8)
    if host_rng is not None:
        rng_json = json.dumps(host_rng.bit_generator.state)
        arrays["host_rng_json"] = np.frombuffer(rng_json.encode("utf-8"), np.uint8)
    if generator is not None:
        arrays["torch_generator_state"] = generator.get_state().numpy()
        arrays["torch_generator_device"] = np.frombuffer(
            generator.device.type.encode("utf-8"), np.uint8)
    np.savez(path, **arrays)


def load(path, device):
    """Returns (TrainState on ``device``, host_rng | None, generator state
    | None).  The generator state (a uint8 CPU tensor for
    ``torch.Generator.set_state``) is None when the file holds none for a
    generator of ``device``'s type: a JAX package checkpoint, or one written
    on another kind of device."""
    with np.load(path) as z:
        state = trainer_mod.state_from_numpy(z, device)
        host_rng = None
        if "host_rng_json" in z:
            host_rng = np.random.default_rng(0)
            host_rng.bit_generator.state = json.loads(
                bytes(z["host_rng_json"]).decode("utf-8"))
        gen_state = None
        if ("torch_generator_state" in z and bytes(z["torch_generator_device"]).decode("utf-8")
                == torch.device(device).type):
            gen_state = torch.from_numpy(np.array(z["torch_generator_state"]))
    return state, host_rng, gen_state


def load_config(path) -> TrainConfig | None:
    with np.load(path) as z:
        if "config_json" not in z:
            return None
        return TrainConfig.from_json(bytes(z["config_json"]).decode("utf-8"))
