"""``scripts/torch_find_nonfinite.py`` on the CPU at a tiny size: the
flagship's self-fit form (3 views of 16x16), a checkpoint with one row made
non-finite by hand, and the finder's stepping against ``Trainer.run``."""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_port_helpers  # noqa: F401  (caps torch at two CPU threads)
from gaussiansplattingmlx_tpu_torch import train_flagship
from gaussiansplattingmlx_tpu_torch.models.gaussians import PARAM_NAMES

REPO = Path(__file__).resolve().parent.parent
TINY = ["--views", "3", "--size", "16", "--gt-gaussians", "300", "--init-points", "128",
        "--max-pairs", "4096", "--max-pairs-limit", "16384", "--iters", "4",
        "--checkpoint-interval", "2"]
ROW = 7


def _finder():
    path = REPO / "scripts" / "torch_find_nonfinite.py"
    spec = importlib.util.spec_from_file_location("torch_find_nonfinite", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclass looks its module up there
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def small_ground_truth_budget():
    """The ground truth renders at 2^14 slots, not 2^22: its 16x16 views
    need 300 pairs, and an overflow would raise."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_flagship, "GT_MAX_PAIRS", 2 ** 14)
        yield


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """ckpt_2.npz and ckpt_4.npz of the tiny run."""
    out = tmp_path_factory.mktemp("run")
    train_flagship.run([*TINY, "--out", str(out), "--device", "cpu"])
    return out


def _planted(run_dir, tmp_path, plant):
    """A copy of ckpt_2.npz under ``tmp_path`` with ``plant(arrays)``
    applied."""
    with np.load(run_dir / "ckpt_2.npz") as z:
        arrays = dict(z)
    plant(arrays)
    np.savez(tmp_path / "ckpt_2.npz", **arrays)


def _find(tmp_path, fixture=False):
    argv = ["--start", "2", "--until", "4", "--record", str(tmp_path / "record.npz"),
            "--device", "cpu"]
    if fixture:
        argv += ["--fixture", str(tmp_path / "fixture.npz")]
    return _finder().main([*argv, "--", *TINY, "--out", str(tmp_path)])


def test_finder_names_a_row_planted_in_the_checkpoint(run_dir, tmp_path):
    """A NaN written into one row's position: the finder names that row at
    the checkpoint's own step, before taking any."""

    def plant(a):
        a["param_xyz"][ROW, 1] = np.nan

    _planted(run_dir, tmp_path, plant)
    res = _find(tmp_path)
    assert res["found"] and res["in_start_state"]
    assert res["step"] == 2 and res["rows"] == [ROW]
    with np.load(tmp_path / "record.npz") as z:
        assert int(z["step"]) == 2 and z["rows"].tolist() == [ROW]


def test_finder_names_the_step_and_the_first_flagged_value(run_dir, tmp_path):
    """An opacity first moment of 3e38 with a zero second moment: the next
    step's Adam update overflows to an infinite opacity.  The finder names
    that step (3), that row and, as the first flagged value in the step's
    order, the moment; the replay of the step is the step's own, and on the
    CPU the plain versions on both sides agree bit for bit."""

    def plant(a):
        a["adam_m_opacity"][ROW, 0] = 3e38
        a["adam_v_opacity"][ROW, 0] = 0.0

    _planted(run_dir, tmp_path, plant)
    res = _find(tmp_path, fixture=True)
    assert res["found"] and not res["in_start_state"]
    assert res["step"] == 3 and res["row"] == ROW and res["rows"] == [ROW]
    assert res["first_flagged"]["stage"] == "adam m opacity"
    assert res["post_nonfinite"] == {n: int(n == "opacity") for n in PARAM_NAMES}
    checks = res["checks"]
    assert checks["replay_equal"] and checks["projection_same_as_step"]
    assert checks["k3_tiles_checked"] == checks["k3_tiles"] >= 1
    for name in ("k3_vs_plain", "k4_vs_plain", "k4_of_plain_k3", "k4_is_d_packed"):
        assert checks[name]["bit_equal"], name
    assert all(c["bit_equal"] for c in checks["row_vjp_vs_step"].values())
    with np.load(tmp_path / "fixture.npz") as z:
        assert int(z["row"]) == ROW and int(z["step"]) == 3
        assert np.isneginf(z["post_param_opacity"]).all()
        assert z["tile_records"].shape[0] == 11 and len(z["tile_ids"]) >= 1
        assert z["tile_blocks"].shape[1:] == (16 * 16, 8)


def test_finder_steps_as_the_trainer_runs(run_dir):
    """The finder's stepping from ckpt_2.npz to step 4 leaves the state that
    ``Trainer.run`` saved at step 4, bit for bit."""
    finder = _finder()
    camp = train_flagship.prepare([*TINY, "--out", str(run_dir), "--device", "cpu"])
    trainer = camp.trainer
    trainer.restore_checkpoint(run_dir / "ckpt_2.npz")
    n = int(trainer.state.num_active)
    assert finder.scan(trainer, range(3, 5), n) is None
    got = finder.state_tensors(trainer.state)
    with np.load(run_dir / "ckpt_4.npz") as z:
        for name in PARAM_NAMES:
            np.testing.assert_array_equal(got[f"param_{name}"].detach().numpy(),
                                          z[f"param_{name}"], err_msg=name)
            np.testing.assert_array_equal(got[f"m_{name}"].numpy(), z[f"adam_m_{name}"])
            np.testing.assert_array_equal(got[f"v_{name}"].numpy(), z[f"adam_v_{name}"])
        assert int(got["step"]) == int(z["step"]) == 4
