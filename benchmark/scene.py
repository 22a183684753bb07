"""Scenes and cameras made from a configuration file and ``--seed``.

A scene is drawn on the device with one seeded ``torch.Generator`` in a few
large calls a group of Gaussians (``scene.groups`` of the configuration):
positions (``normal``: a Gaussian cloud; ``shell``: directions uniform on
the sphere, radius uniform in a range), scales uniform in ``scale`` and
stored as their logs, opacity logits normal, DC colours uniform, higher SH
bands normal with a deviation a band, identity or random (normal,
unnormalised) rotations.  The same seed gives the same scene on the same
device.

Cameras come from the configuration's ``cameras`` rig, the same for every
seed: ``hemisphere`` (the NeRF-synthetic convention: cameras on the upper
hemisphere at one radius, looking at the origin, z up; a Fibonacci spiral
stands in for the dataset's poses) or ``ring`` (a 360-degree ring at one
height, every ``holdout_every``-th pose held out as in the 3DGS split).
``train_views`` of the training poses, evenly spaced, are the ones a cell
uses.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import reference as ref

def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def _uniform(shape, lo, hi, gen, device):
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def draw_scene(cfg: dict, seed: int, device) -> dict:
    """The seed's scene: raw parameters keyed by ``reference.PARAM_NAMES``
    (float32 on ``device``)."""
    sc = cfg["scene"]
    n = int(sc["gaussians"])
    k = (cfg["sh_degree"] + 1) ** 2
    gen = generator(seed, device)
    f32 = dict(dtype=torch.float32, device=device)
    out = {"xyz": torch.empty((n, 3), **f32), "features_dc": torch.empty((n, 1, 3), **f32),
           "features_rest": torch.empty((n, k - 1, 3), **f32),
           "scales": torch.empty((n, 3), **f32), "rotation": torch.empty((n, 4), **f32),
           "opacity": torch.empty((n, 1), **f32)}
    shares = [float(gr["share"]) for gr in sc["groups"]]
    bounds = np.round(np.cumsum([0.0] + shares) / sum(shares) * n).astype(int)
    for gr, a, b in zip(sc["groups"], bounds[:-1], bounds[1:]):
        m = int(b - a)
        if gr["kind"] == "normal":
            xyz = (torch.randn((m, 3), generator=gen, **f32) * torch.tensor(gr["std"], **f32)
                   + torch.tensor(gr.get("center", [0, 0, 0]), **f32))
        elif gr["kind"] == "shell":
            d = torch.randn((m, 3), generator=gen, **f32)
            d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
            xyz = d * _uniform((m, 1), gr["radius"][0], gr["radius"][1], gen, device)
        else:
            raise ValueError(f"unknown scene group kind {gr['kind']!r}")
        out["xyz"][a:b] = xyz
        rgb = _uniform((m, 3), gr["color"][0], gr["color"][1], gen, device)
        out["features_dc"][a:b] = ((rgb - 0.5) / ref.SH_C0)[:, None, :]
        out["features_rest"][a:b] = (torch.randn((m, k - 1, 3), generator=gen, **f32)
                                     * band_std(gr["sh_rest_std"], k, device))
        out["scales"][a:b] = torch.log(
            _uniform((m, 3), gr["scale"][0], gr["scale"][1], gen, device))
        if gr.get("rotation", "identity") == "identity":
            out["rotation"][a:b] = torch.tensor([1.0, 0.0, 0.0, 0.0], **f32)
        else:
            out["rotation"][a:b] = torch.randn((m, 4), generator=gen, **f32)
        out["opacity"][a:b] = (torch.randn((m, 1), generator=gen, **f32) * gr["opacity_logit"][1]
                               + gr["opacity_logit"][0])
    return out


def band_std(stds, k: int, device) -> torch.Tensor:
    """[k - 1, 1] standard deviation of each higher SH coefficient: band l
    (coefficients l^2 .. (l+1)^2 - 1) takes ``stds[l - 1]``."""
    deg = torch.floor(torch.sqrt(torch.arange(1, k, dtype=torch.float32))).long()
    return torch.tensor(stds, dtype=torch.float32)[deg - 1][:, None].to(device)


def jitter(params: dict, spec: dict, seed: int) -> dict:
    """A copy of ``params`` moved off its fit, from ``seed``: positions by
    N(0, (spec.xyz_of_scale x the Gaussian's mean scale)^2), each other
    leaf by N(0, spec[leaf]^2) in its raw parameterisation."""
    dev = params["xyz"].device
    gen = generator(seed + 1, dev)
    out = {}
    for name, x in params.items():
        noise = torch.randn(x.shape, generator=gen, dtype=x.dtype, device=dev)
        if name == "xyz":
            size = torch.exp(params["scales"]).mean(dim=1, keepdim=True)
            out[name] = x + noise * size * spec["xyz_of_scale"]
        else:
            out[name] = x + noise * spec[name]
    return out


def _fibonacci_hemisphere(count: int, radius: float) -> np.ndarray:
    i = np.arange(count) + 0.5
    z = i / count
    phi = i * math.pi * (3.0 - math.sqrt(5.0))
    r = np.sqrt(1.0 - z * z)
    return radius * np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=1)


def training_poses(cfg: dict) -> np.ndarray:
    """[n, 3] positions of the configuration's training cameras, in order."""
    cam = cfg["cameras"]
    if cam["rig"] == "hemisphere":
        return _fibonacci_hemisphere(int(cam["count"]), float(cam["radius"]))
    if cam["rig"] == "ring":
        count = int(cam["count"])
        ang = 2.0 * math.pi * np.arange(count) / count
        keep = np.arange(count) % int(cam["holdout_every"]) != 0
        pos = np.stack([cam["radius"] * np.cos(ang), cam["radius"] * np.sin(ang),
                        np.full(count, float(cam["height"]))], axis=1)
        return pos[keep]
    raise ValueError(f"unknown camera rig {cam['rig']!r}")


def focal(cfg: dict) -> float:
    cam = cfg["cameras"]
    if "camera_angle_x" in cam:
        return 0.5 * cfg["image_width"] / math.tan(0.5 * float(cam["camera_angle_x"]))
    return float(cam["focal_px"])


def camera_at(cfg: dict, position, device) -> ref.Camera:
    f = focal(cfg)
    return ref.camera_from_c2w(ref.look_at_c2w(position), cfg["image_width"],
                               cfg["image_height"], f, f, device)


def train_cameras(cfg: dict, device) -> list:
    """The cell's ``train_views`` training cameras, evenly spaced over all."""
    poses = training_poses(cfg)
    idx = np.floor(np.arange(cfg["train_views"]) * len(poses) / cfg["train_views"]).astype(int)
    return [camera_at(cfg, poses[i], device) for i in idx]


def orbit_positions(cfg: dict, per_pose: int) -> np.ndarray:
    """[n * per_pose, 3] positions on the closed path through every training
    pose in order, ``per_pose`` steps between two poses."""
    poses = training_poses(cfg)
    nxt = np.roll(poses, -1, axis=0)
    f = (np.arange(per_pose) / per_pose)[None, :, None]
    return (poses[:, None] * (1.0 - f) + nxt[:, None] * f).reshape(-1, 3)
