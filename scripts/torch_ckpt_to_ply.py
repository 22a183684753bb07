"""Export a training checkpoint's model to a PLY, with the PyTorch port only.

A run that stops before ``Trainer.run`` ends leaves only ``ckpt_*.npz``
(the PLY of the last step is written when the run completes); this turns
one into the PLY that ``eval_cli``, ``render_cli`` and the viewers read.
Same command line as ``scripts/ckpt_to_ply.py``, and the same bytes out,
for a checkpoint of either package:

    python scripts/torch_ckpt_to_ply.py outputs/run                  # newest
    python scripts/torch_ckpt_to_ply.py outputs/run/ckpt_6000.npz -o m.ply

Runs on the CPU; imports torch, numpy and the port (no JAX).
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def newest_checkpoint(d: Path) -> Path:
    cks = sorted(d.glob("ckpt_*.npz"), key=lambda p: int(p.stem.split("_")[1]))
    if not cks:
        sys.exit(f"no ckpt_*.npz under {d}")
    return cks[-1]


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser()
    ap.add_argument("path", help="checkpoint .npz or a directory of them")
    ap.add_argument("-o", "--out", default=None,
                    help="output .ply (default: iteration_<step>.ply next to "
                    "the checkpoint)")
    args = ap.parse_args(argv)

    from gaussiansplattingmlx_tpu_torch.data import ply
    from gaussiansplattingmlx_tpu_torch.train import checkpoint

    src = Path(args.path)
    if src.is_dir():
        src = newest_checkpoint(src)
    state, _, _ = checkpoint.load(src, "cpu")
    n = int(state.num_active)
    step = int(state.step)
    p = state.params.to_numpy()
    out = Path(args.out) if args.out else src.parent / f"iteration_{step}.ply"
    ply.write_gaussian_ply(
        out, p["xyz"][:n], p["features_dc"][:n], p["features_rest"][:n],
        p["opacity"][:n], p["scales"][:n], p["rotation"][:n],
    )
    print(f"{src} (step {step}, {n} gaussians) -> {out}")
    return out


if __name__ == "__main__":
    main()
