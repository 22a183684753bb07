"""The port's image reading and dataset loaders against Pillow and the JAX
package's loaders: PNG decoding and Pillow's BILINEAR resize bit-equal, the
formats the port refuses, each loader's images, alphas, depths, cameras and
point cloud equal to the JAX loader's on the same files, and the camera and
point-cloud helpers the loaders and the training CLI use."""

import json
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from test_data_loaders import write_blender_fixture, write_colmap_fixture

from gaussiansplattingmlx_tpu.data import blender as jax_blender
from gaussiansplattingmlx_tpu.data import colmap as jax_colmap
from gaussiansplattingmlx_tpu.data import nerfstudio as jax_nerfstudio
from gaussiansplattingmlx_tpu.data import ply as jax_ply
from gaussiansplattingmlx_tpu.utils import camera as jax_camera
from gaussiansplattingmlx_tpu.utils import point_cloud as jax_point_cloud
from gaussiansplattingmlx_tpu_torch.data import blender, colmap, nerfstudio, ply
from gaussiansplattingmlx_tpu_torch.utils import camera, png, point_cloud

VENDOR = Path(__file__).parent / "fixtures" / "vendor_scene"
H, W = 25, 33
MODES = ["L", "RGB", "RGBA", "LA", "I;16"]


def pillow_image(mode, seed=0):
    """A 33x25 image of ``mode`` with smooth and noisy content; RGBA and LA
    with alpha 0, 255 and values between."""
    rng = np.random.default_rng(seed)
    if mode == "I;16":
        arr = (rng.uniform(size=(H, W)) * 65535).astype(np.uint16)
        return Image.fromarray(arr)
    channels = {"L": 1, "RGB": 3, "RGBA": 4, "LA": 2}[mode]
    ramp = np.linspace(0, 255, W)[None, :, None] * np.ones((H, 1, channels))
    arr = np.where(rng.uniform(size=(H, W, channels)) < 0.5, ramp,
                   rng.uniform(size=(H, W, channels)) * 255).astype(np.uint8)
    if mode in ("RGBA", "LA"):
        arr[:4, :, -1] = 0
        arr[4:8, :, -1] = 255
    return Image.fromarray(arr[..., 0] if channels == 1 else arr, mode=mode)


@pytest.mark.parametrize("mode", MODES)
def test_read_png_matches_pillow(tmp_path, mode):
    path = tmp_path / "img.png"
    pillow_image(mode).save(path)
    want = np.asarray(Image.open(path))
    got = png.read_png(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _png_chunk(tag, data):
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))


def _filtered(rows, filters, bpp):
    """PNG filtering of uint8 rows [H, stride] with one filter a row."""
    out = []
    prev = np.zeros(rows.shape[1], np.int32)
    for row, f in zip(rows.astype(np.int32), filters):
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if f == 0:
            pred = np.zeros_like(row)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - up_left
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, up_left))
        out.append(bytes([f]) + ((row - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def write_png_by_hand(path, pixels, color_type, depth, filters, idat_parts=3):
    """A PNG with the given row filters and its image data split over
    ``idat_parts`` IDAT chunks."""
    h, w = pixels.shape[:2]
    rows = (pixels.astype(">u2") if depth == 16 else pixels).reshape(h, -1)
    rows = np.frombuffer(rows.tobytes(), np.uint8).reshape(h, -1)
    bpp = rows.shape[1] // w
    data = zlib.compress(_filtered(rows, filters, bpp))
    cut = np.linspace(0, len(data), idat_parts + 1).astype(int)
    body = [_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, 0))]
    body += [_png_chunk(b"IDAT", data[a:b]) for a, b in zip(cut[:-1], cut[1:])]
    Path(path).write_bytes(png.PNG_SIGNATURE + b"".join(body) + _png_chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", ["none", "sub", "up", "average", "paeth", "mixed"])
@pytest.mark.parametrize("color_type,depth", [(2, 8), (6, 8), (0, 16)])
def test_read_png_row_filters_and_split_idat(tmp_path, filters, color_type, depth):
    rng = np.random.default_rng(1)
    shape = {2: (H, W, 3), 6: (H, W, 4), 0: (H, W)}[color_type]
    top = 65535 if depth == 16 else 255
    pixels = (rng.uniform(size=shape) * top).astype(np.uint16 if depth == 16 else np.uint8)
    pixels[:, : W // 2] = pixels[:, :1]  # long runs, so the filters differ
    kinds = ["none", "sub", "up", "average", "paeth"]
    per_row = (np.arange(H) % 5 if filters == "mixed"
               else np.full(H, kinds.index(filters)))
    path = tmp_path / "hand.png"
    write_png_by_hand(path, pixels, color_type, depth, per_row)
    got = png.read_png(path)
    np.testing.assert_array_equal(got, pixels)
    assert got.dtype == pixels.dtype
    np.testing.assert_array_equal(got, np.asarray(Image.open(path)))


@pytest.mark.parametrize("factor", [0.25, 0.37, 0.5, 1.0])
@pytest.mark.parametrize("mode", MODES)
def test_resize_bilinear_matches_pillow(mode, factor):
    img = pillow_image(mode, seed=2)
    size = (round(img.width * factor), round(img.height * factor))
    want = np.asarray(img.resize(size, Image.BILINEAR))
    got = png.resize_bilinear(np.asarray(img), size)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_resize_bilinear_one_axis_and_upscale():
    """A pass runs only along an axis whose size changes; upscaling uses the
    narrow triangle."""
    img = pillow_image("RGBA", seed=3)
    for size in ((W, 12), (16, H), (50, 40)):
        want = np.asarray(img.resize(size, Image.BILINEAR))
        np.testing.assert_array_equal(png.resize_bilinear(np.asarray(img), size), want)


@pytest.mark.parametrize("kind,match", [
    ("palette", "palette"),
    ("interlaced", "interlaced"),
    ("rgb16", "16-bit colour"),
    ("grey1", "bit depth 1"),
    ("text", "not a PNG or JPEG"),
])
def test_unsupported_images_raise(tmp_path, kind, match):
    path = tmp_path / "bad.png"
    rgb = np.zeros((4, 4, 3), np.uint8)
    if kind == "palette":
        Image.fromarray(rgb).convert("P").save(path)
    elif kind == "interlaced":
        raw = zlib.compress(b"\x00" * 64)
        ihdr = struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 1)
        path.write_bytes(png.PNG_SIGNATURE + _png_chunk(b"IHDR", ihdr)
                         + _png_chunk(b"IDAT", raw) + _png_chunk(b"IEND", b""))
    elif kind == "rgb16":
        write_png_by_hand(path, rgb.astype(np.uint16), 2, 16, np.zeros(4, int))
    elif kind == "grey1":
        Image.fromarray(np.zeros((4, 4), bool)).save(path)
    else:
        path.write_text("not an image")
    with pytest.raises(ValueError, match=match):
        colmap.read_resized(path, 1.0)


def test_jpeg_through_pillow_or_raises(tmp_path, monkeypatch):
    """A JPEG decodes through Pillow to the JAX loader's bytes; without
    Pillow it raises saying no decoder is installed."""
    rng = np.random.default_rng(4)
    path = tmp_path / "img.jpg"
    Image.fromarray((rng.uniform(size=(H, W, 3)) * 255).astype(np.uint8)).save(path)
    for factor in (1.0, 0.5):
        got, _ = colmap.load_image(path, factor, False)
        want, _ = jax_colmap.load_image(path, factor, False)
        np.testing.assert_array_equal(got, want)
    import builtins

    real_import = builtins.__import__

    def no_pillow(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pillow)
    with pytest.raises(ValueError, match="no JPEG decoder is installed"):
        png.read_image(path)


def assert_cameras_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.width, g.height, g.znear, g.zfar) == (w.width, w.height, w.znear, w.zfar)
        assert (g.focal_x, g.focal_y, g.fov_x, g.fov_y) == (w.focal_x, w.focal_y, w.fov_x, w.fov_y)
        np.testing.assert_array_equal(g.c2w, w.c2w)
        gt, wt = g.tensors(), w.tensors()
        assert gt.keys() == wt.keys()
        for k in wt:
            np.testing.assert_array_equal(np.asarray(gt[k]), np.asarray(wt[k]))


def assert_optional_equal(got, want):
    assert (got is None) == (want is None)
    if want is not None:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def assert_scenes_equal(got, want):
    (gd, gp), (wd, wp) = got, want
    assert gd.images.dtype == wd.images.dtype == np.float32
    np.testing.assert_array_equal(gd.images, wd.images)
    assert_optional_equal(gd.alphas, wd.alphas)
    assert_optional_equal(gd.depths, wd.depths)
    assert_cameras_equal(gd.cameras, wd.cameras)
    np.testing.assert_array_equal(gp.coords, wp.coords)
    np.testing.assert_array_equal(gp.colors, wp.colors)
    assert gp.coords.dtype == wp.coords.dtype and gp.colors.dtype == wp.colors.dtype


@pytest.mark.parametrize("factor", [1.0, 0.5, 0.25])
def test_vendor_scene_matches_jax(factor):
    got = colmap.load_colmap(VENDOR, resize_factor=factor)
    want = jax_colmap.load_colmap(VENDOR, resize_factor=factor)
    assert_scenes_equal(got, want)
    assert got[0].num_views == 10 and got[1].size == 4000
    assert (got[0].width, got[0].height) == (round(256 * factor), round(192 * factor))


@pytest.mark.parametrize("white", [False, True])
@pytest.mark.parametrize("factor", [1.0, 0.5])
def test_colmap_fixture_matches_jax(tmp_path, factor, white):
    write_colmap_fixture(tmp_path, np.random.default_rng(0), w=33, h=25)
    # One RGBA image, so that the white background composites.
    img = np.asarray(pillow_image("RGBA", seed=5))
    Image.fromarray(img).save(tmp_path / "images" / "img_1.png")
    kwargs = dict(resize_factor=factor, white_background=white)
    assert_scenes_equal(colmap.load_colmap(tmp_path, **kwargs),
                        jax_colmap.load_colmap(tmp_path, **kwargs))


def test_colmap_rgba_images_keep_alphas(tmp_path):
    write_colmap_fixture(tmp_path, np.random.default_rng(0), w=33, h=25)
    for i in range(3):
        Image.fromarray(np.asarray(pillow_image("RGBA", seed=i))).save(
            tmp_path / "images" / f"img_{i}.png")
    got = colmap.load_colmap(tmp_path, resize_factor=0.5, white_background=True)
    assert got[0].alphas is not None and got[0].alphas.shape == (3, 12, 16)
    assert_scenes_equal(got, jax_colmap.load_colmap(tmp_path, resize_factor=0.5,
                                                    white_background=True))


@pytest.mark.parametrize("white", [False, True])
@pytest.mark.parametrize("factor", [1.0, 0.5])
def test_blender_fixture_matches_jax(tmp_path, factor, white):
    write_blender_fixture(tmp_path, np.random.default_rng(0), n_images=2, w=33, h=25)
    # Alpha below 1 somewhere, so that the composite and the depth mask act.
    alpha = np.asarray(pillow_image("L", seed=6))
    Image.fromarray(alpha, mode="L").save(tmp_path / "r_0_alpha.png")
    kwargs = dict(resize_factor=factor, white_background=white)
    assert_scenes_equal(blender.load_blender(tmp_path, **kwargs),
                        jax_blender.load_blender(tmp_path, **kwargs))


def test_blender_without_depth_draws_the_bbox_cloud(tmp_path):
    write_blender_fixture(tmp_path, np.random.default_rng(0), n_images=2, w=33, h=25)
    info = json.loads((tmp_path / "info.json").read_text())
    for img in info["images"]:
        del img["depth"]
    info["bbox"] = [[-2, -1, 0], [2, 1, 3]]
    (tmp_path / "info.json").write_text(json.dumps(info))
    got = blender.load_blender(tmp_path, white_background=True)
    assert got[0].depths is None and got[1].size == 100_000
    assert_scenes_equal(got, jax_blender.load_blender(tmp_path, white_background=True))


def write_nerfstudio_scene(root, with_ply, rng):
    """Three frames: global intrinsics, one frame with its own, one path
    without a suffix, one RGBA image; ``with_ply`` adds an ascii xyz + rgb
    cloud as ``ply_file_path``."""
    w, h = 33, 25
    frames = []
    for i in range(3):
        img = np.asarray(pillow_image("RGBA" if i == 2 else "RGB", seed=10 + i))
        Image.fromarray(img).save(root / f"frame_{i}.png")
        pose = np.eye(4)
        pose[:3, :3] = jax_colmap._quat_to_rot(*rng.normal(size=4))
        pose[:3, 3] = rng.normal(size=3)
        frame = {"file_path": f"frame_{i}" if i == 1 else f"frame_{i}.png",
                 "transform_matrix": pose.tolist()}
        if i == 0:
            frame.update(fl_x=40.0, fl_y=41.0, w=w, h=h)
        frames.append(frame)
    meta = {"fl_x": 25.0, "fl_y": 26.0, "cx": w / 2, "cy": h / 2, "w": w, "h": h,
            "frames": frames}
    if with_ply:
        pts = rng.normal(size=(40, 3))
        cols = rng.integers(0, 256, size=(40, 3))
        lines = [f"{x} {y} {z} {r} {g} {b}" for (x, y, z), (r, g, b) in zip(pts, cols)]
        header = ["ply", "format ascii 1.0", "element vertex 40",
                  *[f"property float {c}" for c in "xyz"],
                  *[f"property uchar {c}" for c in ("red", "green", "blue")], "end_header"]
        (root / "init.ply").write_text("\n".join(header + lines) + "\n")
        meta["ply_file_path"] = "init.ply"
    (root / "transforms.json").write_text(json.dumps(meta))


@pytest.mark.parametrize("white", [False, True])
@pytest.mark.parametrize("with_ply", [False, True])
def test_nerfstudio_matches_jax(tmp_path, with_ply, white):
    write_nerfstudio_scene(tmp_path, with_ply, np.random.default_rng(7))
    kwargs = dict(resize_factor=0.5, white_background=white, init_points_fallback=500, seed=3)
    got = nerfstudio.load_nerfstudio(tmp_path, **kwargs)
    assert got[1].size == (40 if with_ply else 500)
    assert got[0].cameras[0].focal_x == pytest.approx(40.0 * 16 / 33)
    assert_scenes_equal(got, jax_nerfstudio.load_nerfstudio(tmp_path, **kwargs))


def test_centering_and_camera_shift_match_jax():
    data, pcd = colmap.load_colmap(VENDOR, resize_factor=0.25)
    jdata, jpcd = jax_colmap.load_colmap(VENDOR, resize_factor=0.25)
    # Outliers for the 3-sigma cull.
    far = np.full((5, 3), 40.0, np.float32)
    pcd = point_cloud.PointCloud(np.concatenate([pcd.coords, far]),
                                 np.concatenate([pcd.colors, far]))
    jpcd = jax_point_cloud.PointCloud(pcd.coords.copy(), pcd.colors.copy())
    cpcd, centroid = pcd.centering()
    jcpcd, jcentroid = jpcd.centering()
    assert cpcd.size == jcpcd.size == 4000
    np.testing.assert_array_equal(centroid, jcentroid)
    np.testing.assert_array_equal(cpcd.coords, jcpcd.coords)
    np.testing.assert_array_equal(cpcd.colors, jcpcd.colors)
    assert_cameras_equal(data.shift_cameras(centroid).cameras,
                         jdata.shift_cameras(jcentroid).cameras)
    assert camera.spatial_lr_scale_auto(data.cameras) == \
        jax_camera.spatial_lr_scale_auto(jdata.cameras)


def test_camera_helpers_match_jax():
    rng = np.random.default_rng(8)
    for _ in range(3):
        pose = np.eye(4)
        pose[:3, :3] = jax_colmap._quat_to_rot(*rng.normal(size=4))
        pose[:3, 3] = rng.normal(size=3)
        np.testing.assert_array_equal(camera.opengl_to_opencv_c2w(pose),
                                      jax_camera.opengl_to_opencv_c2w(pose))
        K = np.array([[30.0, 0, 16], [0, 31.0, 12], [0, 0, 1]])
        assert_cameras_equal([camera.Camera.from_intrinsics(32, 24, K, pose)],
                             [jax_camera.Camera.from_intrinsics(32, 24, K, pose)])


def test_point_cloud_from_depth_matches_jax():
    rng = np.random.default_rng(9)
    b, h, w = 2, 12, 16
    rgbs = rng.uniform(size=(b, h, w, 3)).astype(np.float32)
    depths = rng.uniform(1, 5, size=(b, h, w)).astype(np.float32)
    alphas = (rng.uniform(size=(b, h, w)) < 0.7).astype(np.float32)
    Ks = np.stack([np.array([[20.0, 0, 8], [0, 21.0, 6], [0, 0, 1]])] * b)
    c2ws = np.stack([camera.opengl_to_opencv_c2w(np.eye(4))] * b)
    got = point_cloud.point_cloud_from_depth(rgbs, depths, alphas, Ks, c2ws)
    want = jax_point_cloud.point_cloud_from_depth(rgbs, depths, alphas, Ks, c2ws)
    assert got.size == int(alphas.sum())
    np.testing.assert_array_equal(got.coords, want.coords)
    np.testing.assert_array_equal(got.colors, want.colors)
    for g, w_ in zip(point_cloud.rays_from_camera(h, w, Ks[0], c2ws[0]),
                     jax_point_cloud.rays_from_camera(h, w, Ks[0], c2ws[0])):
        np.testing.assert_array_equal(g, w_)


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian"])
@pytest.mark.parametrize("color", ["none", "uchar", "float"])
def test_read_point_cloud_ply_matches_jax(tmp_path, fmt, color):
    rng = np.random.default_rng(10)
    n = 30
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("nx", "<f8")]
    if color != "none":
        ctype = "u1" if color == "uchar" else "<f4"
        fields += [(c, ctype) for c in ("red", "green", "blue")]
    rec = np.zeros(n, dtype=fields)
    for name, _ in fields:
        rec[name] = rng.normal(size=n)
    if color == "uchar":
        for c in ("red", "green", "blue"):
            rec[c] = rng.integers(0, 256, size=n)
    elif color == "float":
        for c in ("red", "green", "blue"):
            rec[c] = rng.uniform(size=n)
    names = {"<f4": "float", "<f8": "double", "u1": "uchar"}
    header = (f"ply\nformat {fmt} 1.0\ncomment made by a test\nelement vertex {n}\n"
              + "".join(f"property {names[t]} {name}\n" for name, t in fields)
              + "element face 0\nproperty list uchar int vertex_indices\nend_header\n")
    if fmt == "ascii":
        body = "".join(" ".join(repr(float(v)) if isinstance(v, float) else str(v)
                                for v in row.tolist()) + "\n" for row in rec).encode()
    else:
        body = rec.tobytes()
    path = tmp_path / "cloud.ply"
    path.write_bytes(header.encode() + body)
    got_pts, got_cols = ply.read_point_cloud_ply(path)
    want_pts, want_cols = jax_ply.read_point_cloud_ply(path)
    np.testing.assert_array_equal(got_pts, want_pts)
    assert_optional_equal(got_cols, want_cols)
    if color == "uchar":
        assert got_cols.max() <= 1.0
