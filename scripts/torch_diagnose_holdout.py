"""Held-out quality forensics with the PyTorch port: render held-out views
under Gaussian-subset ablations to find what hazes novel views
(near-camera floaters, SH overfit, translucent giants).

    python scripts/torch_diagnose_holdout.py outputs/run/ckpt_30000.npz \
        --dataset-root outputs/vendor_scene_800 --views 0,9 [--device cuda]

Each ablation prints the PSNR of every view and their mean, as
``scripts/diagnose_holdout.py`` prints them; the mechanism is whichever cull
recovers the most dB.  A line before them gives the sky dome's (r > 5)
Gaussians, mean opacity and mean SH-rest energy (sum of the squared
higher-band coefficients) beside the rest's; the next counts the live rows
holding a NaN or an infinity, in all and by parameter.  Ablations zero the
opacity of the culled rows (or the SH coefficients above a degree) instead
of dropping them, so every render has the same shapes.  ``--device``
defaults to ``cuda``; a missing card is an error.  Imports torch, numpy and
the port (no JAX).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

ABLATIONS = ("full", "sh_degree=0", "sh_degree=1", "cull r>5 (sky dome)", "cull r in 2..5",
             "cull d_cam<0.5", "cull d_cam<1.0", "cull opacity<0.05", "cull opacity<0.2",
             "cull smax>0.3", "cull d_cam<1 & op<0.05")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt")
    ap.add_argument("--dataset-root", required=True)
    ap.add_argument("--views", default="0,9,18,27")
    ap.add_argument("--resize-factor", type=float, default=1.0)
    ap.add_argument("--save", default=None, help="directory for each render's PNG")
    ap.add_argument("--max-pairs", type=int, default=8388608)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from gaussiansplattingmlx_tpu_torch.config import RasterizerConfig
    from gaussiansplattingmlx_tpu_torch.data import colmap
    from gaussiansplattingmlx_tpu_torch.models.gaussians import activations, params_from_numpy
    from gaussiansplattingmlx_tpu_torch.ops import losses
    from gaussiansplattingmlx_tpu_torch.render import render
    from gaussiansplattingmlx_tpu_torch.utils import png
    from gaussiansplattingmlx_tpu_torch.utils.sh import num_sh_coeffs

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available")

    data, pcd = colmap.load_colmap(args.dataset_root, resize_factor=args.resize_factor)
    pcd, centroid = pcd.centering()
    data = data.shift_cameras(centroid)

    with np.load(args.ckpt) as d:
        n = int(d["num_active"])
        raw = {k: d[f"param_{k}"][:n] for k in ("xyz", "features_dc", "features_rest",
                                                 "scales", "rotation", "opacity")}
    params = params_from_numpy(raw, device)
    sh_degree = params.sh_degree
    means, shs, opacity, scales, rots = (t.detach() for t in activations(params))
    means_np = means.cpu().numpy()
    r = np.linalg.norm(means_np, axis=1)
    smax = scales.cpu().numpy().max(axis=1)
    op_np = opacity.cpu().numpy()[:, 0]
    rest_energy = (params.features_rest.detach().cpu().numpy().reshape(n, -1) ** 2).sum(axis=1)
    dome = r > 5.0

    def mean(x):
        return float(x.mean()) if x.size else float("nan")

    print(f"sky dome (r > 5): {int(dome.sum())} of {n} Gaussians, mean opacity "
          f"{mean(op_np[dome]):.4f}, mean SH-rest energy {mean(rest_energy[dome]):.4f}; "
          f"the rest: opacity {mean(op_np[~dome]):.4f}, SH-rest energy "
          f"{mean(rest_energy[~dome]):.4f}", flush=True)
    bad = {k: ~np.isfinite(v.reshape(n, -1)).all(axis=1) for k, v in raw.items()}
    print(f"non-finite rows: {int(np.any(list(bad.values()), axis=0).sum())} of {n} ("
          + ", ".join(f"{k} {int(b.sum())}" for k, b in bad.items()) + ")", flush=True)

    cam_pos = np.stack([np.asarray(c.tensors()["camera_center"]).reshape(3)
                        for c in data.cameras])
    # distance from each gaussian to the nearest camera (chunked)
    d_cam = np.full(n, np.inf, np.float32)
    for i in range(0, n, 65536):
        blk = means_np[i:i + 65536]
        dd = np.linalg.norm(blk[:, None, :] - cam_pos[None], axis=-1)
        d_cam[i:i + 65536] = dd.min(axis=1)

    cfg = RasterizerConfig(max_pairs=args.max_pairs)
    view_ids = [int(v) for v in args.views.split(",")]

    def render_views(mask, sh_deg, tag):
        kept = int(mask.sum())
        o_m = torch.where(torch.as_tensor(mask, device=device)[:, None], opacity, 0.0)
        s_m = shs
        if sh_deg < sh_degree:
            keep_coef = num_sh_coeffs(sh_deg)
            coef_mask = (torch.arange(shs.shape[1], device=device) < keep_coef)[None, :, None]
            s_m = torch.where(coef_mask, shs, 0.0)
        psnrs = []
        for vi in view_ids:
            t = data.cameras[vi].tensors()
            with torch.no_grad():
                out, _ = render(
                    means, s_m, o_m, scales, rots,
                    *(torch.as_tensor(np.asarray(t[k])).to(device)
                      for k in ("view", "proj", "camera_center")),
                    t["fov_x"], t["fov_y"], t["focal_x"], t["focal_y"],
                    data.width, data.height, sh_degree, raster_cfg=cfg, inference=True,
                )
            target = torch.as_tensor(data.images[vi]).to(device)
            psnrs.append(float(losses.psnr(out.color, target)))
            if args.save:
                Path(args.save).mkdir(parents=True, exist_ok=True)
                img = np.clip(out.color.cpu().numpy() * 255, 0, 255).astype(np.uint8)
                name = tag.replace(" ", "_").replace("<", "lt").replace(">", "gt")
                png.write_png(Path(args.save) / f"{name}_v{vi:03d}.png", img)
        print(f"{tag:28s} kept {kept:6d}/{n}  "
              f"psnr/view {' '.join(f'{p:5.2f}' for p in psnrs)}  "
              f"mean {np.mean(psnrs):5.2f}", flush=True)
        return psnrs

    all_mask = np.ones(n, bool)
    cases = (
        (all_mask, sh_degree), (all_mask, 0), (all_mask, 1),
        (r < 5.0, sh_degree), (~((r > 2.0) & (r < 5.0)), sh_degree),
        (d_cam > 0.5, sh_degree), (d_cam > 1.0, sh_degree),
        (op_np > 0.05, sh_degree), (op_np > 0.2, sh_degree), (smax < 0.3, sh_degree),
        ((d_cam > 1.0) & (op_np > 0.05), sh_degree),
    )
    return {tag: render_views(mask, deg, tag) for tag, (mask, deg) in zip(ABLATIONS, cases)}


if __name__ == "__main__":
    main()
