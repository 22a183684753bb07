"""The port's native COLMAP parsers (data/native_io.py, built at first use
with the host C++ compiler from gaussiansplattingmlx_tpu_torch/native/)
against its pure-Python parsers, bit for bit: on written fixtures (every
camera model the loaders read, images with 2D points, points with tracks)
and on the vendored scene; truncated files raise, and camera models the
loaders do not read raise in both; a failed build raises with the
compiler's log; builders that run at once leave one whole library.  And
the demo fetchers (data/fetch.py) with the download monkeypatched: no test
touches the network."""

import ctypes
import io
import struct
import threading
import urllib.error
import zipfile
from pathlib import Path

import numpy as np
import pytest

from test_data_loaders import write_colmap_fixture

from gaussiansplattingmlx_tpu_torch import train_cli
from gaussiansplattingmlx_tpu_torch.data import colmap, fetch, native_io

VENDOR = Path(__file__).resolve().parent / "fixtures" / "vendor_scene"


def _assert_equal(got, want):
    """Nested dicts / lists / arrays equal in type, shape, dtype and bits."""
    assert type(got) is type(want), (type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_equal(a, b)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    else:
        assert got == want


def _write_cameras(path, models):
    """cameras.bin with one camera of each (model id, params)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(models)))
        for i, (model, params) in enumerate(models):
            f.write(struct.pack("<iiQQ", 7 + i, model, 640 + i, 480 - i))
            f.write(struct.pack(f"<{len(params)}d", *params))


def _sparse_dirs(tmp_path):
    root = tmp_path / "scene"
    write_colmap_fixture(root, np.random.default_rng(0), n_images=4, n_points=300)
    _write_cameras(root / "sparse" / "0" / "cameras.bin",
                   [(0, (500.5, 320.25, 240.125)), (1, (501.0, 502.5, 319.5, 241.0)),
                    (2, (503.0, 321.0, 239.0, 0.01)),
                    (4, (504.0, 505.0, 318.0, 242.0, 0.1, -0.2, 0.003, 0.004))])
    return [root / "sparse" / "0", VENDOR / "sparse" / "0"]


def test_native_parsers_match_python(tmp_path):
    for sparse in _sparse_dirs(tmp_path):
        for native, plain in ((colmap.read_cameras_bin, colmap.read_cameras_bin_plain),
                              (colmap.read_images_bin, colmap.read_images_bin_plain),
                              (colmap.read_points3d_bin, colmap.read_points3d_bin_plain)):
            name = {"read_cameras_bin": "cameras.bin", "read_images_bin": "images.bin",
                    "read_points3d_bin": "points3D.bin"}[native.__name__]
            _assert_equal(native(sparse / name), plain(sparse / name))
    cams = colmap.read_cameras_bin(tmp_path / "scene" / "sparse" / "0" / "cameras.bin")
    assert sorted(cams) == [7, 8, 9, 10] and cams[7]["fx"] == cams[7]["fy"] == 500.5
    images = colmap.read_images_bin(VENDOR / "sparse" / "0" / "images.bin")
    assert len(images) == 10 and [im["image_id"] for im in images] != [0] * 10


def test_native_parsers_raise_on_corrupt_files_and_unread_models(tmp_path):
    """A truncated file raises (the Python parser skips a point's track
    without a bounds check); a camera model the loaders do not read raises
    in both parsers."""
    sparse = _sparse_dirs(tmp_path)[0]
    data = (sparse / "points3D.bin").read_bytes()
    with pytest.raises(ValueError, match="points3D"):
        native_io.parse_points3d(data[:-5])
    data = (sparse / "images.bin").read_bytes()
    with pytest.raises(ValueError, match="images"):
        native_io.parse_images(data[:-10])
    _write_cameras(tmp_path / "cams.bin", [(3, (1.0, 2.0, 3.0, 0.1, 0.2))])  # RADIAL
    with pytest.raises(ValueError, match="camera model"):
        colmap.read_cameras_bin(tmp_path / "cams.bin")
    with pytest.raises(ValueError, match="camera model"):
        colmap.read_cameras_bin_plain(tmp_path / "cams.bin")


def _crafted_point(track_len):
    """points3D.bin of one point whose track length is ``track_len``,
    followed by one track entry: 8 bytes, what a wrapped ``track_len * 8``
    would skip."""
    return (struct.pack("<QQ3d3BdQ", 1, 1, 0.5, 1.5, 2.5, 1, 2, 3, 0.25, track_len)
            + struct.pack("<ii", 0, 0))


def _crafted_image(npts):
    """images.bin of one image with ``npts`` 2D points, followed by one
    point: 24 bytes, what a wrapped ``npts * 24`` would skip."""
    return (struct.pack("<Qi7di", 1, 1, 1.0, 0, 0, 0, 0, 0, 0, 1) + b"a.png\x00"
            + struct.pack("<Q", npts) + struct.pack("<ddq", 1.0, 2.0, -1))


@pytest.mark.parametrize("parse, data", [
    (native_io.parse_points3d, _crafted_point(2 ** 61 + 1)),   # * 8 wraps to 8
    (native_io.parse_points3d, _crafted_point(2 ** 64 - 2)),   # * 8 wraps below 0
    (native_io.parse_images, _crafted_image(2 ** 61 + 1)),     # * 24 wraps to 24
    (native_io.parse_images, _crafted_image(2 ** 64 - 1)),     # * 24 wraps below 0
], ids=["track_wraps", "track_back", "npts_wraps", "npts_back"])
def test_native_parsers_refuse_crafted_lengths(parse, data):
    """A length read from the file is compared with the bytes left before it
    is multiplied: a count whose product wraps raises instead of skipping a
    few bytes or stepping backwards."""
    with pytest.raises(ValueError, match="corrupt"):
        parse(data)


def test_failed_build_raises_with_the_compiler_log(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(native_io, "SOURCE", bad)
    monkeypatch.setattr(native_io, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="native COLMAP parser failed(.|\n)*bad.cpp"):
        native_io.build()
    assert list((tmp_path / "build").iterdir()) == []


def test_concurrent_builds_leave_one_library(tmp_path, monkeypatch):
    """Four builders at once: each compiles to a file of its own and renames
    it into place; one whole library remains, and no temporary file."""
    monkeypatch.setattr(native_io, "BUILD_DIR", tmp_path / "build")
    paths, errors = [], []

    def run():
        try:
            paths.append(native_io.build())
        except Exception as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=run) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(set(paths)) == 1
    assert [p.name for p in (tmp_path / "build").iterdir()] == [paths[0].name]
    assert ctypes.CDLL(str(paths[0])).gsplat_parse_cameras


# --- the demo fetchers ---------------------------------------------------------


def _zip_bytes(entries):
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        for name, payload in entries.items():
            zf.writestr(name, payload)
    return buf.getvalue()


def test_fetch_skip_if_present(tmp_path, monkeypatch):
    def boom(url, timeout):
        raise AssertionError("network touched despite the probe file")

    monkeypatch.setattr(fetch, "_download_zip", boom)
    probe = tmp_path / "sparse" / "0" / "cameras.bin"
    probe.parent.mkdir(parents=True)
    probe.write_bytes(b"")
    assert fetch.fetch_lego_colmap(tmp_path) == tmp_path
    (tmp_path / "info.json").write_text("{}")
    assert fetch.fetch_chair_blender(tmp_path) == tmp_path


def test_fetch_extracts_zip_once(tmp_path, monkeypatch):
    payload = _zip_bytes({"sparse/0/cameras.bin": b"demo", "images/a.png": b"x"})
    urls = []
    monkeypatch.setattr(fetch, "_download_zip", lambda url, timeout: urls.append(url) or payload)
    root = fetch.fetch_lego_colmap(tmp_path / "lego")
    assert urls == [fetch.LEGO_COLMAP_URL]
    assert (root / "sparse" / "0" / "cameras.bin").read_bytes() == b"demo"
    fetch.fetch_lego_colmap(root)  # the probe file is there now
    assert len(urls) == 1


def test_fetch_rejects_path_traversal(tmp_path, monkeypatch):
    evil = _zip_bytes({"../escape.txt": b"nope"})
    monkeypatch.setattr(fetch, "_download_zip", lambda url, timeout: evil)
    with pytest.raises(fetch.FetchError, match="escapes"):
        fetch.fetch_chair_blender(tmp_path / "chair")
    assert not (tmp_path / "escape.txt").exists()


def test_fetch_download_failure_is_a_fetch_error(tmp_path, monkeypatch):
    def offline(url, timeout):
        raise urllib.error.URLError("no route to host")

    monkeypatch.setattr(fetch.urllib.request, "urlopen", offline)
    with pytest.raises(fetch.FetchError, match="could not download.*no route"):
        fetch.fetch_lego_colmap(tmp_path / "lego", timeout=0.1)
    assert not (tmp_path / "lego").exists()


def test_train_cli_fetch_demo_trains(tmp_path, monkeypatch, capsys):
    """train_cli --fetch-demo lego: the (monkeypatched) download unpacks a
    COLMAP scene into --root, which then trains; --fetch-demo chair with
    --dataset colmap raises before any download."""
    scene = tmp_path / "src"
    write_colmap_fixture(scene, np.random.default_rng(1))
    entries = {p.relative_to(scene).as_posix(): p.read_bytes()
               for p in scene.rglob("*") if p.is_file()}
    urls = []
    monkeypatch.setattr(fetch, "_download_zip",
                        lambda url, timeout: urls.append(url) or _zip_bytes(entries))
    root, out = tmp_path / "lego", tmp_path / "out"
    res = train_cli.main(["--dataset", "colmap", "--root", str(root), "--fetch-demo", "lego",
                          "--output", str(out), "--iterations", "2", "--sh-degree", "1",
                          "--resize-factor", "1.0", "--device", "cpu"])
    assert urls == [fetch.LEGO_COLMAP_URL]
    assert "fetching demo scene 'lego'" in capsys.readouterr().out
    assert (root / "sparse" / "0" / "points3D.bin").exists()
    assert res.final["iteration"] == 2 and np.isfinite(res.final["loss"])
    with pytest.raises(ValueError, match="chair is a blender scene"):
        train_cli.main(["--dataset", "colmap", "--root", str(root), "--fetch-demo", "chair",
                        "--output", str(out), "--device", "cpu"])
    assert urls == [fetch.LEGO_COLMAP_URL]
