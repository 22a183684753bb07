"""Gaussian PLY checkpoint format (numpy only; the port's copy of the JAX
package's ``data/ply.py``, byte-compatible with it).

binary_little_endian 1.0 with a ``comment features_rest_shape M 3`` line and
per-vertex float32 fields x,y,z,f_dc_0..2,f_rest_0..(M*3-1),opacity,
scale_0..2,rot_0..3.  Raw (pre-activation) parameters are stored.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass
class GaussianPly:
    xyz: np.ndarray  # [N, 3]
    features_dc: np.ndarray  # [N, 1, 3]
    features_rest: np.ndarray  # [N, M, 3]
    opacity: np.ndarray  # [N, 1]
    scales: np.ndarray  # [N, 3]
    rotation: np.ndarray  # [N, 4]


def write_gaussian_ply(
    path,
    xyz: np.ndarray,
    features_dc: np.ndarray,
    features_rest: np.ndarray,
    opacity: np.ndarray,
    scales: np.ndarray,
    rotation: np.ndarray,
) -> None:
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    n = xyz.shape[0]
    features_dc = np.asarray(features_dc, np.float32).reshape(n, 3)
    features_rest = np.asarray(features_rest, np.float32).reshape(n, -1, 3)
    m = features_rest.shape[1]
    opacity = np.asarray(opacity, np.float32).reshape(n)
    scales = np.asarray(scales, np.float32).reshape(n, 3)
    rotation = np.asarray(rotation, np.float32).reshape(n, 4)

    header = ["ply", "format binary_little_endian 1.0"]
    header.append(f"comment features_rest_shape {m} 3")
    header.append(f"element vertex {n}")
    for f in ("x", "y", "z", "f_dc_0", "f_dc_1", "f_dc_2"):
        header.append(f"property float {f}")
    for i in range(m * 3):
        header.append(f"property float f_rest_{i}")
    for f in ("opacity", "scale_0", "scale_1", "scale_2", "rot_0", "rot_1", "rot_2", "rot_3"):
        header.append(f"property float {f}")
    header.append("end_header")

    body = np.concatenate(
        [xyz, features_dc, features_rest.reshape(n, m * 3), opacity[:, None],
         scales, rotation],
        axis=1,
    ).astype("<f4")

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(("\n".join(header) + "\n").encode("ascii"))
        fh.write(body.tobytes())


def read_gaussian_ply(path) -> GaussianPly:
    data = Path(path).read_bytes()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii").splitlines()
    if header[0].strip() != "ply":
        raise ValueError("not a PLY file")
    n = 0
    props: list[str] = []
    rest_m = None
    binary = True
    for line in header[1:]:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            binary = parts[1] == "binary_little_endian"
        elif parts[0] == "comment" and len(parts) >= 4 and parts[1] == "features_rest_shape":
            rest_m = int(parts[2])
        elif parts[0] == "element" and parts[1] == "vertex":
            n = int(parts[2])
        elif parts[0] == "property":
            props.append(parts[-1])
    if not binary:
        raise ValueError("gaussian PLY must be binary_little_endian")
    table = np.frombuffer(data[end:], dtype="<f4", count=n * len(props)).reshape(
        n, len(props)
    )
    col = {name: i for i, name in enumerate(props)}
    rest_cols = sorted(
        (name for name in props if name.startswith("f_rest_")),
        key=lambda s: int(s.split("_")[-1]),
    )
    m = rest_m if rest_m is not None else len(rest_cols) // 3
    if rest_cols:
        rest = table[:, [col[c] for c in rest_cols]].reshape(n, m, 3)
    else:
        rest = np.zeros((n, 0, 3), np.float32)
    return GaussianPly(
        xyz=table[:, [col["x"], col["y"], col["z"]]].copy(),
        features_dc=table[:, [col["f_dc_0"], col["f_dc_1"], col["f_dc_2"]]]
        .reshape(n, 1, 3).copy(),
        features_rest=rest.copy(),
        opacity=table[:, [col["opacity"]]].copy(),
        scales=table[:, [col["scale_0"], col["scale_1"], col["scale_2"]]].copy(),
        rotation=table[
            :, [col["rot_0"], col["rot_1"], col["rot_2"], col["rot_3"]]
        ].copy(),
    )
