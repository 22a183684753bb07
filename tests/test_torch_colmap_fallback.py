"""COLMAP loading where the native parser cannot be built: with no C++
compiler (``$CXX`` naming a missing file and ``c++`` / ``g++`` not found),
with a build directory that cannot be written, and with one that cannot be
created.  ``native_io.library()`` returns None and prints one stderr line,
once per process; ``read_points3d_bin`` and ``load_colmap`` parse in Python
and give the vendored scene bit for bit as the library does.  A library already
built loads without a compiler, and the loader sends only points3D.bin
through the native parser."""

import errno
import re
from pathlib import Path

import numpy as np
import pytest

from test_torch_native_io import _assert_equal

from gaussiansplattingmlx_tpu_torch.data import colmap, native_io

VENDOR = Path(__file__).resolve().parent / "fixtures" / "vendor_scene"
SPARSE = VENDOR / "sparse" / "0"


def _fresh(monkeypatch, build_dir):
    """A process's first use: nothing loaded, nothing known missing."""
    monkeypatch.setattr(native_io, "BUILD_DIR", build_dir)
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_missing", None)


def _scene():
    data, pcd = colmap.load_colmap(VENDOR, resize_factor=0.25)
    return data, pcd, colmap.read_points3d_bin(SPARSE / "points3D.bin")


def _assert_scenes_equal(got, want):
    (gd, gp, gr), (wd, wp, wr) = got, want
    _assert_equal(gd.images, wd.images)
    assert gd.alphas is None and wd.alphas is None
    for a, b in zip(gd.cameras, wd.cameras):
        _assert_equal(a.tensors(), b.tensors())
    _assert_equal(gp.coords, wp.coords)
    _assert_equal(gp.colors, wp.colors)
    _assert_equal(gr, wr)


def _no_compiler(monkeypatch, tmp_path):
    monkeypatch.setenv("CXX", str(tmp_path / "missing" / "c++"))
    monkeypatch.setattr(native_io.shutil, "which",
                        lambda name, *a, **k: None if name in ("c++", "g++") else
                        (name if Path(name).is_file() else None))
    return "no C++ compiler"


def _read_only(monkeypatch, tmp_path):
    def refuse(*args, **kwargs):
        raise OSError(errno.EROFS, "Read-only file system")

    monkeypatch.setattr(native_io.tempfile, "mkstemp", refuse)
    return "cannot be created or written (Read-only file system)"


def _not_creatable(monkeypatch, tmp_path):
    (tmp_path / "file").write_text("")
    monkeypatch.setattr(native_io, "BUILD_DIR", tmp_path / "file" / "_build")
    return "cannot be created or written"


@pytest.mark.parametrize("cause", [_no_compiler, _read_only, _not_creatable],
                         ids=["no_compiler", "read_only_build_dir", "uncreatable_build_dir"])
def test_unbuildable_library_falls_back_to_python(tmp_path, monkeypatch, capsys, cause):
    _fresh(monkeypatch, tmp_path / "built")
    assert native_io.library() is not None
    want = _scene()
    capsys.readouterr()

    _fresh(monkeypatch, tmp_path / "fresh")
    why = cause(monkeypatch, tmp_path)
    got = _scene()
    _assert_scenes_equal(got, want)
    _scene()  # a second load says nothing more
    assert native_io.library() is None
    out = capsys.readouterr()
    lines = out.err.splitlines()
    assert len(lines) == 1, out.err
    assert lines[0].startswith("native COLMAP parser unavailable: ") and why in lines[0]
    assert lines[0].endswith("; parsing in Python")
    assert out.out == ""
    with pytest.raises(native_io.Unavailable, match=re.escape(why.split(" (")[0])):
        native_io.parse_points3d((SPARSE / "points3D.bin").read_bytes())


def test_built_library_loads_without_a_compiler(tmp_path, monkeypatch, capsys):
    _fresh(monkeypatch, tmp_path / "built")
    path = native_io.build()
    _fresh(monkeypatch, tmp_path / "built")
    _no_compiler(monkeypatch, tmp_path)
    lib = native_io.library()
    assert lib is not None and Path(lib._name) == path
    assert capsys.readouterr().err == ""


def test_loader_parses_only_points_natively(monkeypatch):
    """load_colmap reads cameras.bin and images.bin in Python and sends
    points3D.bin through the native parser."""
    calls = []
    for name in ("parse_cameras", "parse_images", "parse_points3d"):
        real = getattr(native_io, name)
        monkeypatch.setattr(native_io, name,
                            lambda data, _r=real, _n=name: calls.append(_n) or _r(data))
    data, pcd = colmap.load_colmap(VENDOR, resize_factor=0.25)
    assert calls == ["parse_points3d"]
    assert len(data.cameras) == 10 and pcd.coords.shape[0] > 0
    assert np.isfinite(pcd.coords).all()
