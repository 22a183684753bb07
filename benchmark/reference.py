"""The benchmark's plain reference of one 3D Gaussian Splatting view and one
training step: plain PyTorch, written from the published method (Kerbl et
al. 2023) with the conventions the system under test states, and importing
nothing of it.

    activations -> projection (EWA, SH colour) -> tile binning and a stable
    (tile, depth) sort -> front-to-back compositing per pixel -> L1 + SSIM
    -> gradients by autograd -> Adam without bias correction.

Conventions (those of the system's rasterizer configuration):
  * row-vector camera matrices (``p_view = [x, 1] @ view``), +1e-6 on clip w,
    a cull at view z < 0.2, the EWA ``t`` clamp at 1.3 tan(fov / 2), +0.3 on
    the 2D covariance's diagonal, a determinant guard (det <= 1e-12 -> 1);
  * SH evaluated on the unnormalised direction ``mean - camera``, +0.5,
    clamped at 0;
  * radius 3 ceil(sqrt(lambda_max)), lambda_max = mid + sqrt(max(mid^2 - det,
    1e-5)); the screen rect clamped at 0 and at W-1 / H-1;
  * alpha = min(opacity exp(-d^T conic d / 2), 0.99) at integer pixel
    coordinates; record i is taken while the transmittance before it is
    >= 1e-4; no alpha < 1/255 skip.

The view transform and the EWA covariance are written as explicit sums of
products, so that no matrix library (and no TF32) decides their rounding:
the depths that order the pairs are then those a plain float32 evaluation
gives.

Compositing runs tiles in batches and each tile's depth-sorted records in
chunks, carrying the transmittance from chunk to chunk and stopping a batch
once every pixel in it has stopped: exact, since no later record is taken.
The backward recomputes each batch under autograd, so memory stays that of
one batch.  ``dtype`` runs the whole of it in another precision (the
benchmark's control); matrix products run with TF32 off.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
         -0.4570457994644658, 1.445305721320277, -0.5900435899266435)

Z_CULL = 0.2
W_EPS = 1e-6
TANFOV_CLIP = 1.3
COV2D_DILATION = 0.3
RADIUS_EIGEN_EPS = 1e-5
QUAT_EPS = 1e-8
ALPHA_CLAMP = 0.99
T_EPS = 1e-4
ZNEAR, ZFAR = 0.1, 100.0
# Records of a tile taken in one chunk, and (pixel, record) entries of a batch.
CHUNK = 256
MAX_ELEMS = 2 ** 25

PARAM_NAMES = ("xyz", "features_dc", "features_rest", "scales", "rotation", "opacity")


@contextlib.contextmanager
def no_tf32():
    """Full float32 matrix products for the duration (restored after)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class Camera(NamedTuple):
    """One view: row-vector ``view`` = w2c^T and ``proj`` = P^T [4, 4],
    ``center`` [3] (float32 tensors), and python floats."""
    view: torch.Tensor
    proj: torch.Tensor
    center: torch.Tensor
    fov_x: float
    fov_y: float
    focal_x: float
    focal_y: float
    width: int
    height: int


def camera_from_c2w(c2w: np.ndarray, width: int, height: int, focal_x: float,
                    focal_y: float, device) -> Camera:
    """A camera from an OpenCV camera-to-world matrix (x right, y down, z
    forward) and focal lengths in pixels, planes at ZNEAR and ZFAR; float64
    on the host, float32 on ``device``."""
    znear, zfar = ZNEAR, ZFAR
    c2w = np.asarray(c2w, np.float64)
    fov_x = 2.0 * math.atan(width / (2.0 * focal_x))
    fov_y = 2.0 * math.atan(height / (2.0 * focal_y))
    w2c = np.linalg.inv(c2w)
    p = np.zeros((4, 4))
    p[0, 0] = 1.0 / math.tan(fov_x / 2.0)
    p[1, 1] = 1.0 / math.tan(fov_y / 2.0)
    p[2, 2] = zfar / (zfar - znear)
    p[2, 3] = -(znear * zfar) / (zfar - znear)
    p[3, 2] = 1.0

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(device)

    return Camera(view=t(w2c.T), proj=t(p.T), center=t(c2w[:3, 3]),
                  fov_x=float(np.float32(fov_x)), fov_y=float(np.float32(fov_y)),
                  focal_x=float(np.float32(focal_x)), focal_y=float(np.float32(focal_y)),
                  width=int(width), height=int(height))


def on(cam: Camera, device) -> Camera:
    """``cam`` with its tensors on ``device``."""
    return cam._replace(view=cam.view.to(device), proj=cam.proj.to(device),
                        center=cam.center.to(device))


def look_at_c2w(position) -> np.ndarray:
    """OpenCV camera-to-world of a camera at ``position`` looking at the
    origin, z up."""
    pos = np.asarray(position, np.float64)
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, pos
    return c2w


# --- activations, projection, SH ----------------------------------------------------


def eval_sh(degree: int, sh: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """SH colour before +0.5 for coefficients ``sh`` [N, K, 3] along the
    (unnormalised) directions ``d`` [N, 3]; degrees 0-3."""
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    out = SH_C0 * sh[:, 0]
    if degree >= 1:
        out = out - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2] - SH_C1 * x * sh[:, 3]
    if degree >= 2:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        out = (out + SH_C2[0] * xy * sh[:, 4] + SH_C2[1] * yz * sh[:, 5]
               + SH_C2[2] * (2.0 * zz - xx - yy) * sh[:, 6] + SH_C2[3] * xz * sh[:, 7]
               + SH_C2[4] * (xx - yy) * sh[:, 8])
    if degree >= 3:
        out = (out + SH_C3[0] * y * (3.0 * xx - yy) * sh[:, 9]
               + SH_C3[1] * xy * z * sh[:, 10]
               + SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[:, 11]
               + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[:, 12]
               + SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[:, 13]
               + SH_C3[5] * z * (xx - yy) * sh[:, 14]
               + SH_C3[6] * x * (xx - 3.0 * yy) * sh[:, 15])
    if degree >= 4:
        raise ValueError("the reference evaluates SH degrees 0-3")
    return out


class Projected(NamedTuple):
    means2d: torch.Tensor  # [N, 2]
    conic: torch.Tensor  # [N, 4] (c00, c01, c10, c11) of the inverse covariance
    colors: torch.Tensor  # [N, 3]
    opacity: torch.Tensor  # [N]
    depths: torch.Tensor  # [N] (no gradient)
    radii: torch.Tensor  # [N] (no gradient, 0 = culled)
    rect_min: torch.Tensor  # [N, 2] (no gradient)
    rect_max: torch.Tensor  # [N, 2]


def project(params: dict, cam: Camera, sh_degree: int) -> Projected:
    """Raw parameters (``PARAM_NAMES``) -> the screen-space quantities of
    every Gaussian in ``cam``, differentiable in the parameters."""
    dt = params["xyz"].dtype
    dev = params["xyz"].device
    means = params["xyz"]
    scales = torch.exp(params["scales"])
    q = params["rotation"]
    opacity = torch.sigmoid(params["opacity"]).reshape(-1)
    shs = torch.cat([params["features_dc"], params["features_rest"]], dim=1)
    view, proj = cam.view.to(dt), cam.proj.to(dt)
    one = torch.ones((), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)

    def rows(a, m):  # [N, K] @ [K, J] as a left-to-right sum of K products
        out = a[:, 0:1] * m[0]
        for k in range(1, m.shape[0]):
            out = out + a[:, k:k + 1] * m[k]
        return out

    p_view = rows(torch.cat([means, torch.ones_like(means[:, :1])], dim=1), view)
    p_clip = rows(p_view, proj)
    depth = p_view[:, 2]
    visible = depth >= Z_CULL
    w_inv = 1.0 / torch.where(visible, p_clip[:, 3] + W_EPS, one)
    ndc = p_clip * w_inv[:, None]
    mean_x = ((ndc[:, 0] + 1.0) * cam.width - 1.0) * 0.5
    mean_y = ((ndc[:, 1] + 1.0) * cam.height - 1.0) * 0.5

    qn = q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + QUAT_EPS * QUAT_EPS)
    w, x, y, z = qn.unbind(-1)
    rot = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)
    lmat = rot * scales[:, None, :]
    cov3d = torch.sum(lmat[:, :, None, :] * lmat[:, None, :, :], dim=-1)

    # EWA: the rows b0, b1 of J W (W = the world-to-view rotation), then
    # cov2d = (J W) cov3d (J W)^T.
    t = rows(means, view[:3, :3]) + view[3, :3]
    tz = torch.where(visible, t[:, 2], one)
    lim_x = torch.tan(torch.tensor(cam.fov_x, dtype=dt, device=dev) * 0.5) * TANFOV_CLIP
    lim_y = torch.tan(torch.tensor(cam.fov_y, dtype=dt, device=dev) * 0.5) * TANFOV_CLIP
    tx = t[:, 0] / torch.minimum(torch.maximum(tz, -lim_x), lim_x) * tz
    ty = t[:, 1] / torch.minimum(torch.maximum(tz, -lim_y), lim_y) * tz
    fx = torch.tensor(cam.focal_x, dtype=dt, device=dev)
    fy = torch.tensor(cam.focal_y, dtype=dt, device=dev)
    wrot = view[:3, :3].T
    b0 = (fx / tz)[:, None] * wrot[0][None, :] + (-tx * fx / (tz * tz))[:, None] * wrot[2][None, :]
    b1 = (fy / tz)[:, None] * wrot[1][None, :] + (-ty * fy / (tz * tz))[:, None] * wrot[2][None, :]
    c3b0 = torch.sum(cov3d * b0[:, None, :], dim=-1)
    c3b1 = torch.sum(cov3d * b1[:, None, :], dim=-1)
    c00 = torch.sum(b0 * c3b0, dim=-1) + COV2D_DILATION
    c01 = torch.sum(b0 * c3b1, dim=-1)
    c10 = torch.sum(b1 * c3b0, dim=-1)
    c11 = torch.sum(b1 * c3b1, dim=-1) + COV2D_DILATION
    det = c00 * c11 - c01 * c10
    det = torch.where(visible & (det > 1e-12), det, one)
    conic = torch.stack([c11 / det, -c01 / det, -c10 / det, c00 / det], dim=-1)

    rgb = torch.clamp_min(eval_sh(sh_degree, shs, means - cam.center.to(dt)) + 0.5, 0.0)

    with torch.no_grad():
        mid = 0.5 * (c00 + c11)
        lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, RADIUS_EIGEN_EPS))
        radii = torch.where(visible, 3.0 * torch.ceil(torch.sqrt(lam)), zero)
        rect_min = torch.stack([torch.clamp_min(mean_x - radii, 0.0),
                                torch.clamp_min(mean_y - radii, 0.0)], -1)
        rect_max = torch.stack([torch.clamp_max(mean_x + radii, cam.width - 1.0),
                                torch.clamp_max(mean_y + radii, cam.height - 1.0)], -1)
    return Projected(torch.stack([mean_x, mean_y], -1), conic, rgb, opacity,
                     depth.detach(), radii, rect_min, rect_max)


# --- binning --------------------------------------------------------------------------


class Bins(NamedTuple):
    gid: torch.Tensor  # [P] int64 Gaussian of each pair, (tile, depth) order
    tile_start: torch.Tensor  # [T] int64
    tile_count: torch.Tensor  # [T] int64
    grid_w: int
    grid_h: int
    tile: int


def footprints(p: Projected, width: int, height: int, tile: int):
    """(tmin_x, tmin_y, rw, rh) int64 of each Gaussian's tile rect: floor of
    the rect over the tile, +1 at the far side, clipped to the grid; 0 wide
    where the Gaussian is culled."""
    grid_w, grid_h = -(-width // tile), -(-height // tile)

    def fdiv(v):
        return torch.clamp(torch.floor(v.float() / float(tile)), -2.0 ** 30, 2.0 ** 30).long()

    tx0 = torch.clamp(fdiv(p.rect_min[:, 0]), 0, grid_w)
    ty0 = torch.clamp(fdiv(p.rect_min[:, 1]), 0, grid_h)
    tx1 = torch.clamp(fdiv(p.rect_max[:, 0]) + 1, 0, grid_w)
    ty1 = torch.clamp(fdiv(p.rect_max[:, 1]) + 1, 0, grid_h)
    live = p.radii > 0
    rw = torch.where(live, tx1 - tx0, 0)
    rh = torch.where(live, ty1 - ty0, 0)
    return tx0, ty0, rw, rh


def pair_count(p: Projected, width: int, height: int, tile: int) -> int:
    """The pairs a view needs: the sum of the Gaussians' tile footprints."""
    _, _, rw, rh = footprints(p, width, height, tile)
    return int(torch.sum(rw * rh))


def bin_pairs(p: Projected, width: int, height: int, tile: int) -> Bins:
    """Every (Gaussian, tile) pair, Gaussian-major, then ONE stable sort by
    (tile, depth): ties keep the Gaussian order."""
    dev = p.radii.device
    grid_w, grid_h = -(-width // tile), -(-height // tile)
    tx0, ty0, rw, rh = footprints(p, width, height, tile)
    foot = rw * rh
    gid = torch.repeat_interleave(torch.arange(foot.shape[0], device=dev), foot)
    first = torch.cumsum(foot, 0) - foot
    local = torch.arange(gid.shape[0], device=dev) - first[gid]
    w = rw[gid]
    tile_id = (ty0[gid] + local // w) * grid_w + tx0[gid] + local % w
    depth_bits = p.depths.float()[gid].view(torch.int32).long()
    order = torch.sort((tile_id << 32) | depth_bits, stable=True).indices
    gid, tile_id = gid[order], tile_id[order]
    count = torch.bincount(tile_id, minlength=grid_w * grid_h)
    start = torch.cumsum(count, 0) - count
    return Bins(gid, start, count, grid_w, grid_h, tile)


# --- compositing ----------------------------------------------------------------------


class TileWork(NamedTuple):
    """What compositing a view takes: pairs, (pixel, record) evaluations
    until each pixel stops (``pixel_records``), and the records a tile
    replays until its last pixel stops (``replayed``)."""
    pairs: int
    pixel_records: int
    replayed: int


def _batches(bins: Bins, tt: int):
    """Tiles that hold records, longest first, in batches of at most
    MAX_ELEMS / (tt * CHUNK) tiles."""
    tiles = torch.nonzero(bins.tile_count > 0).reshape(-1)
    tiles = tiles[torch.argsort(bins.tile_count[tiles], descending=True)]
    per = max(1, MAX_ELEMS // (tt * CHUNK))
    for i in range(0, tiles.numel(), per):
        yield tiles[i:i + per]


def _composite_batch(ts, bins: Bins, leaves, dtype, ncon_out=None):
    """Front-to-back compositing of the tiles ``ts`` [B] with the records
    ``leaves`` (means2d, conic, colors, opacity).  Returns (color [B, TT, 3],
    alpha [B, TT]); adds each pixel's taken records to ``ncon_out`` [B, TT]
    when given."""
    means2d, conic, colors, opacity = leaves
    tile = bins.tile
    tt = tile * tile
    dev = ts.device
    pix = torch.arange(tt, device=dev)
    px = ((ts % bins.grid_w) * tile)[:, None] + (pix % tile)[None, :]
    py = ((ts // bins.grid_w) * tile)[:, None] + (pix // tile)[None, :]
    px, py = px.to(dtype)[:, :, None], py.to(dtype)[:, :, None]
    start, count = bins.tile_start[ts], bins.tile_count[ts]
    b = ts.shape[0]
    trans = torch.ones((b, tt), dtype=dtype, device=dev)  # prod (1 - a), unmasked
    kept = torch.ones((b, tt), dtype=dtype, device=dev)  # prod (1 - a m)
    color = torch.zeros((b, tt, 3), dtype=dtype, device=dev)
    longest = int(count.max())
    for c0 in range(0, longest, CHUNK):
        j = c0 + torch.arange(min(CHUNK, longest - c0), device=dev)
        valid = j[None, :] < count[:, None]
        g = bins.gid[torch.where(valid, start[:, None] + j[None, :], 0)]
        dx = px - means2d[g, 0][:, None, :]
        dy = py - means2d[g, 1][:, None, :]
        cg = conic[g]
        e = -0.5 * (dx * dx * cg[:, None, :, 0] + dy * dy * cg[:, None, :, 3]
                    + dx * dy * (cg[:, None, :, 1] + cg[:, None, :, 2]))
        a = torch.clamp_max(torch.exp(e) * opacity[g][:, None, :], ALPHA_CLAMP)
        a = torch.where(valid[:, None, :], a, 0.0)
        om = 1.0 - a
        cp = torch.cumprod(om, dim=-1)
        tu = trans[:, :, None] * torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], -1)
        m = (tu >= T_EPS) & valid[:, None, :]
        wgt = torch.where(m, tu * a, 0.0)
        color = color + torch.bmm(wgt, colors[g])
        kept = kept * torch.prod(torch.where(m, om, 1.0), dim=-1)
        trans = trans * cp[..., -1]
        if ncon_out is not None:
            ncon_out += m.sum(-1)
        if not bool((trans >= T_EPS).any()):
            break
    return color, 1.0 - kept


def _untile(x: torch.Tensor, bins: Bins, width: int, height: int) -> torch.Tensor:
    """[T, TT, C] -> [H, W, C]."""
    t = bins.tile
    c = x.shape[-1]
    x = x.reshape(bins.grid_h, bins.grid_w, t, t, c).permute(0, 2, 1, 3, 4)
    return x.reshape(bins.grid_h * t, bins.grid_w * t, c)[:height, :width]


def _tile_view(img: torch.Tensor, bins: Bins) -> torch.Tensor:
    """[H, W, C] -> [T, TT, C], zeros past the image's edge."""
    t = bins.tile
    h, w, c = img.shape
    pad = img.new_zeros((bins.grid_h * t, bins.grid_w * t, c))
    pad[:h, :w] = img
    pad = pad.reshape(bins.grid_h, t, bins.grid_w, t, c).permute(0, 2, 1, 3, 4)
    return pad.reshape(bins.grid_h * bins.grid_w, t * t, c)


def _leaves(p: Projected):
    return (p.means2d, p.conic, p.colors, p.opacity)


@torch.no_grad()
def composite(p: Projected, bins: Bins, width: int, height: int, white: bool,
              count_work: bool = False):
    """The view's image [H, W, 3] with the background applied and, with
    ``count_work``, its ``TileWork``."""
    dtype = p.means2d.dtype
    tt = bins.tile * bins.tile
    num_tiles = bins.grid_w * bins.grid_h
    color = torch.zeros((num_tiles, tt, 3), dtype=dtype, device=p.means2d.device)
    alpha = torch.zeros((num_tiles, tt), dtype=dtype, device=p.means2d.device)
    ncon = torch.zeros((num_tiles, tt), dtype=torch.int64, device=p.means2d.device)
    leaves = tuple(x.detach() for x in _leaves(p))
    for ts in _batches(bins, tt):
        n = torch.zeros((ts.shape[0], tt), dtype=torch.int64, device=ts.device)
        color[ts], alpha[ts] = _composite_batch(ts, bins, leaves, dtype, n)
        ncon[ts] = n
    img = color + (1.0 - alpha)[..., None] if white else color
    img = _untile(img, bins, width, height)
    if not count_work:
        return img
    replayed = torch.minimum(ncon.max(dim=1).values, bins.tile_count)
    return img, TileWork(pairs=int(bins.tile_count.sum()), pixel_records=int(ncon.sum()),
                         replayed=int(replayed.sum()))


def composite_backward(p: Projected, bins: Bins, grad_img: torch.Tensor, white: bool):
    """Backpropagate d loss / d image [H, W, 3] through the compositing and
    the projection into the parameters (their ``.grad``)."""
    dtype = p.means2d.dtype
    tt = bins.tile * bins.tile
    gcol = _tile_view(grad_img.to(dtype), bins)  # [T, TT, 3]
    galpha = -gcol.sum(-1) if white else torch.zeros_like(gcol[..., 0])
    leaves = [x.detach().requires_grad_() for x in _leaves(p)]
    for ts in _batches(bins, tt):
        with torch.enable_grad():
            color, alpha = _composite_batch(ts, bins, leaves, dtype)
            torch.autograd.backward([color, alpha], [gcol[ts], galpha[ts]])
    torch.autograd.backward(
        list(_leaves(p)),
        [x.grad if x.grad is not None else torch.zeros_like(x) for x in leaves])


# --- loss ------------------------------------------------------------------------------


def _gauss_taps():
    """SSIM's 11 Gaussian taps of sigma 1.5, normalised, as float32 values."""
    xs = np.arange(11, dtype=np.float64)
    g = np.exp(-((xs - 5) ** 2) / (2.0 * 1.5 ** 2))
    return [float(v) for v in (g / g.sum()).astype(np.float32)]


def _blur(x: torch.Tensor, taps) -> torch.Tensor:
    """Zero-padded separable blur of [..., H, W, C] along H then W."""
    r = len(taps) // 2
    for axis in (x.dim() - 3, x.dim() - 2):
        n = x.shape[axis]
        pad = [0, 0] * (x.dim() - 1 - axis) + [r, r]
        xp = torch.nn.functional.pad(x, pad)
        out = taps[0] * xp.narrow(axis, 0, n)
        for k in range(1, len(taps)):
            out = out + taps[k] * xp.narrow(axis, k, n)
        x = out
    return x


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of [H, W, 3] images: 11-tap Gaussian window of sigma 1.5,
    C1 = 0.01^2, C2 = 0.03^2, zero padding."""
    s = _blur(torch.stack([a, b, a * a, b * b, a * b]), _gauss_taps())
    mu1, mu2 = s[0], s[1]
    s1, s2, s12 = s[2] - mu1 * mu1, s[3] - mu2 * mu2, s[4] - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    num = (2.0 * mu1 * mu2 + c1) * (2.0 * s12 + c2)
    den = (mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2)
    return torch.mean(num / den)


def loss_fn(img: torch.Tensor, target: torch.Tensor, lambda_dssim: float = 0.2):
    """(1 - l) L1 + l (1 - SSIM)."""
    return ((1.0 - lambda_dssim) * torch.mean(torch.abs(img - target))
            + lambda_dssim * (1.0 - ssim(img, target)))


# --- whole view and whole step ---------------------------------------------------------


def render(params: dict, cam: Camera, sh_degree: int, tile: int, white: bool,
           count_work: bool = False):
    """The image of ``cam`` (and its ``TileWork`` with ``count_work``)."""
    with no_tf32(), torch.no_grad():
        p = project(params, cam, sh_degree)
        bins = bin_pairs(p, cam.width, cam.height, tile)
        return composite(p, bins, cam.width, cam.height, white, count_work)


def work(params: dict, cam: Camera, tile: int) -> TileWork:
    """The compositing work of ``cam`` (colours play no part in it)."""
    return render(params, cam, 0, tile, False, count_work=True)[1]


class StepOut(NamedTuple):
    loss: float
    image: torch.Tensor  # [H, W, 3] the rendered view
    grads: dict  # name -> gradient as the optimizer got it


def adam(params: dict, grads: dict, m: dict, v: dict, lrs: dict, beta1: float = 0.9,
         beta2: float = 0.999, eps: float = 1e-15) -> None:
    """One Adam step without bias correction, in place."""
    for n, p in params.items():
        g = grads[n]
        m[n].mul_(beta1).add_((1.0 - beta1) * g)
        v[n].mul_(beta2).add_((1.0 - beta2) * (g * g))
        p.sub_(lrs[n] * m[n] / (torch.sqrt(v[n]) + eps))


def train_step(params: dict, m: dict, v: dict, cam: Camera, target: torch.Tensor,
               sh_degree: int, tile: int, white: bool, lrs: dict) -> StepOut:
    """One training step on one view: render, L1 + SSIM against ``target``,
    the gradients of every raw parameter, Adam (in place on ``params``, ``m``
    and ``v``)."""
    dtype = params["xyz"].dtype
    with no_tf32():
        leaves = {n: x.detach().requires_grad_() for n, x in params.items()}
        with torch.enable_grad():
            p = project(leaves, cam, sh_degree)
        bins = bin_pairs(p, cam.width, cam.height, tile)
        img = composite(p, bins, cam.width, cam.height, white)
        img_l = img.detach().requires_grad_()
        with torch.enable_grad():
            loss = loss_fn(img_l, target.to(dtype))
            loss.backward()
        composite_backward(p, bins, img_l.grad, white)
        grads = {n: leaves[n].grad for n in PARAM_NAMES}
        with torch.no_grad():
            adam(params, grads, m, v, lrs)
    return StepOut(float(loss.detach()), img, grads)
