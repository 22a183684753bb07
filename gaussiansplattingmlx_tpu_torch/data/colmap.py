"""COLMAP binary dataset loader (the port's copy of the JAX package's
``data/colmap.py``).

``read_*_bin`` parse a ``sparse/`` file with the native library
(``native_io``, built at first use), as the JAX package does when its
library is built; ``read_*_bin_plain`` are the same parsers in numpy +
struct, the plain versions the tests hold the native ones to.
``load_colmap`` sends only points3D.bin through the native parser
(``read_points3d_bin``, which parses in Python where the library cannot be
built): cameras.bin and images.bin parse as fast in Python
(``scripts/torch_colmap_parse_bench.py``).  Camera
models SIMPLE_PINHOLE, PINHOLE, SIMPLE_RADIAL and OPENCV (focal and center
only; distortion is ignored); an image's pose quat(w, x, y, z) + t is
world -> camera, converted to c2w = [R^T | -R^T t]; the points' tracks are
skipped.  Layout: <root>/sparse/0/*.bin (or <root>/sparse/*.bin) and
<root>/images.  Images are read and resized by ``utils/png.py``, to the
bytes Pillow gives the JAX package.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.camera import Camera
from ..utils.png import read_image, resize_bilinear
from ..utils.point_cloud import PointCloud
from . import native_io
from .dataset import TrainData

CAMERA_MODEL_PARAMS = {
    0: 3,  # SIMPLE_PINHOLE: f, cx, cy
    1: 4,  # PINHOLE: fx, fy, cx, cy
    2: 4,  # SIMPLE_RADIAL: f, cx, cy, k
    4: 8,  # OPENCV: fx, fy, cx, cy, k1, k2, p1, p2
}


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read(self, fmt: str):
        size = struct.calcsize(fmt)
        out = struct.unpack_from("<" + fmt, self.data, self.pos)
        self.pos += size
        return out

    def read_string(self) -> str:
        end = self.data.index(b"\x00", self.pos)
        s = self.data[self.pos:end].decode("utf-8")
        self.pos = end + 1
        return s


def read_cameras_bin(path) -> Dict[int, dict]:
    """camera_id -> intrinsics dict (width, height, fx, fy, cx, cy)."""
    return native_io.parse_cameras(Path(path).read_bytes())


def read_cameras_bin_plain(path) -> Dict[int, dict]:
    r = _Reader(Path(path).read_bytes())
    (n,) = r.read("Q")
    cams = {}
    for _ in range(n):
        cam_id, model_id = r.read("ii")
        width, height = r.read("QQ")
        if model_id not in CAMERA_MODEL_PARAMS:
            raise ValueError(f"unsupported COLMAP camera model {model_id}")
        params = r.read("d" * CAMERA_MODEL_PARAMS[model_id])
        if model_id in (0, 2):  # single focal
            fx = fy = params[0]
            cx, cy = params[1], params[2]
        else:
            fx, fy, cx, cy = params[0], params[1], params[2], params[3]
        cams[cam_id] = dict(width=int(width), height=int(height), fx=fx, fy=fy, cx=cx, cy=cy)
    return cams


def _image(image_id, camera_id, name, qvec, tvec) -> dict:
    """An image's entry; the pose quat(w, x, y, z) + t is world -> camera,
    c2w = [R^T | -R^T t]."""
    R = _quat_to_rot(*qvec)
    c2w = np.eye(4)
    c2w[:3, :3] = R.T
    c2w[:3, 3] = -R.T @ np.asarray(tvec)
    return dict(image_id=image_id, camera_id=camera_id, name=name, c2w=c2w)


def read_images_bin(path) -> List[dict]:
    """Every image's id, camera id, file name and c2w, sorted by name."""
    images = [_image(im["image_id"], im["camera_id"], im["name"], im["qvec"], im["tvec"])
              for im in native_io.parse_images(Path(path).read_bytes())]
    images.sort(key=lambda d: d["name"])
    return images


def read_images_bin_plain(path) -> List[dict]:
    r = _Reader(Path(path).read_bytes())
    (n,) = r.read("Q")
    images = []
    for _ in range(n):
        (image_id,) = r.read("i")
        qvec = r.read("dddd")
        tvec = r.read("ddd")
        (camera_id,) = r.read("i")
        name = r.read_string()
        (num_pts,) = r.read("Q")
        r.pos += num_pts * struct.calcsize("<ddq")  # skip the 2D points
        images.append(_image(image_id, camera_id, name, qvec, tvec))
    images.sort(key=lambda d: d["name"])
    return images


def read_points3d_bin(path) -> Tuple[np.ndarray, np.ndarray]:
    """(xyz [N, 3] float32, rgb [N, 3] float32 in 0..255)."""
    if native_io.library() is None:
        return read_points3d_bin_plain(path)
    return native_io.parse_points3d(Path(path).read_bytes())


def read_points3d_bin_plain(path) -> Tuple[np.ndarray, np.ndarray]:
    r = _Reader(Path(path).read_bytes())
    (n,) = r.read("Q")
    xyz = np.empty((n, 3), np.float32)
    rgb = np.empty((n, 3), np.float32)
    for i in range(n):
        r.read("Q")  # point id
        xyz[i] = r.read("ddd")
        rgb[i] = r.read("BBB")
        r.read("d")  # reprojection error
        (track_len,) = r.read("Q")
        r.pos += track_len * 8  # (image_id, point2D_idx) int32 pairs
    return xyz, rgb


def _quat_to_rot(w, x, y, z) -> np.ndarray:
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def read_resized(path, resize_factor: float) -> np.ndarray:
    """The image's pixels as uint8 (uint16 for 16-bit grey), resized to
    round(size * resize_factor) unless the factor is 1."""
    img = read_image(path)
    if resize_factor != 1.0:
        h, w = img.shape[:2]
        img = resize_bilinear(img, (round(w * resize_factor), round(h * resize_factor)))
    return img


def load_image(path, resize_factor: float, white_background: bool):
    """PNG/JPEG -> float32 [H, W, 3] in [0, 1] (+ alpha [H, W] if the image
    has four channels), composited over white as alpha * rgb + (1 - alpha)
    with ``white_background``."""
    arr = read_resized(path, resize_factor).astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.repeat(arr[:, :, None], 3, axis=2)
    alpha = None
    if arr.shape[2] == 4:
        alpha = arr[:, :, 3]
        rgb = arr[:, :, :3]
        if white_background:
            rgb = alpha[:, :, None] * rgb + (1.0 - alpha[:, :, None])
    else:
        rgb = arr[:, :, :3]
    return rgb, alpha


def load_colmap(
    root,
    resize_factor: float = 1.0,
    white_background: bool = False,
    images_dir: Optional[str] = None,
    znear: float = 0.1,
    zfar: float = 100.0,
) -> Tuple[TrainData, PointCloud]:
    """Load a COLMAP scene: ``root`` holds sparse/0/ and images/."""
    root = Path(root)
    sparse = root / "sparse" / "0"
    if not sparse.exists():
        sparse = root / "sparse"
    img_dir = Path(images_dir) if images_dir else root / "images"

    cams = read_cameras_bin_plain(sparse / "cameras.bin")
    images = read_images_bin_plain(sparse / "images.bin")
    xyz, rgb = read_points3d_bin(sparse / "points3D.bin")

    cameras, rgbs, alphas = [], [], []
    have_alpha = True
    for im in images:
        intr = cams[im["camera_id"]]
        pixels, alpha = load_image(img_dir / im["name"], resize_factor, white_background)
        h, w = pixels.shape[:2]
        # Intrinsics scaled with the image.
        sx = w / intr["width"]
        sy = h / intr["height"]
        cameras.append(
            Camera.from_c2w(w, h, intr["fx"] * sx, intr["fy"] * sy, im["c2w"], znear, zfar))
        rgbs.append(pixels)
        if alpha is None:
            have_alpha = False
        alphas.append(alpha)

    data = TrainData(
        cameras=cameras,
        images=np.stack(rgbs),
        alphas=np.stack(alphas) if have_alpha else None,
    )
    return data, PointCloud(coords=xyz, colors=rgb)
