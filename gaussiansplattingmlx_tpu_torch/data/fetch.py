"""Demo-scene fetchers (the port's copy of the JAX package's
``data/fetch.py``: the same URLs, probe files and errors).

  * lego (COLMAP format): a zip from the TinyGaussianSplattingDataset
    repository, unpacked into the destination; skipped when
    ``sparse/0/cameras.bin`` is already there.
  * B075X65R3X chair (Blender format): a zip from the torch-splatting
    repository; skipped when ``info.json`` or ``transforms_train.json`` is
    there.

Each downloads to memory, refuses archive members that would land outside
the destination, then extracts.  Without network access the download fails
at once with ``FetchError``; the loaders take any directory, so nothing
else needs this module.
"""

from __future__ import annotations

import io
import urllib.error
import urllib.request
import zipfile
from pathlib import Path

LEGO_COLMAP_URL = (
    "https://raw.githubusercontent.com/tatsuya-ogawa/"
    "TinyGaussianSplattingDataset/refs/heads/main/colmap/lego.zip"
)
CHAIR_BLENDER_URL = (
    "https://raw.githubusercontent.com/hbb1/torch-splatting/"
    "refs/heads/main/B075X65R3X.zip"
)


class FetchError(RuntimeError):
    """A demo scene could not be downloaded or unpacked safely."""


def _download_zip(url: str, timeout: float) -> bytes:
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.read()
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        raise FetchError(
            f"could not download demo dataset from {url!r}: {e}. "
            "This environment may have no network access — point --root at "
            "an existing dataset directory instead."
        ) from e


def _extract(data: bytes, dest: Path) -> None:
    dest.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(io.BytesIO(data)) as zf:
        for member in zf.infolist():
            # A hostile archive may name paths outside dest.
            target = dest / member.filename
            if not target.resolve().is_relative_to(dest.resolve()):
                raise FetchError(f"zip member escapes dest: {member.filename!r}")
        zf.extractall(dest)


def fetch_lego_colmap(dest: str | Path, *, timeout: float = 60.0) -> Path:
    """Download and unpack the lego COLMAP demo scene into ``dest`` unless
    ``sparse/0/cameras.bin`` is there.  Returns the scene root (the
    ``--root`` of the CLIs)."""
    dest = Path(dest)
    if (dest / "sparse" / "0" / "cameras.bin").exists():
        return dest
    _extract(_download_zip(LEGO_COLMAP_URL, timeout), dest)
    return dest


def fetch_chair_blender(dest: str | Path, *, timeout: float = 60.0) -> Path:
    """Download and unpack the chair Blender demo scene into ``dest`` unless
    ``info.json`` or ``transforms_train.json`` is there."""
    dest = Path(dest)
    if (dest / "info.json").exists() or (dest / "transforms_train.json").exists():
        return dest
    _extract(_download_zip(CHAIR_BLENDER_URL, timeout), dest)
    return dest


# --fetch-demo name -> (dataset format, fetcher)
DEMOS = {
    "lego": ("colmap", fetch_lego_colmap),
    "chair": ("blender", fetch_chair_blender),
}
