"""Rank functions for the port's data- and tile-parallel tests
(tests/test_torch_parallel.py, tests/test_torch_multihost.py).

``parallel.launch.spawn`` runs each in fresh processes, one a rank, on the
CPU over gloo; this module imports no JAX, so that the ranks start fast.
Each returns (result, report): rank 0's result comes back to the test, and
every rank's report with the launcher's own measures.
"""

import numpy as np
import torch

from gaussiansplattingmlx_tpu_torch.parallel import multihost, sharding
from gaussiansplattingmlx_tpu_torch.train import trainer as trainer_mod


def _step(cfg, width, height, views_np, state_np, mesh, idx, chosen=None):
    """One data-/tile-parallel step from ``state_np`` on this rank's view
    ``idx[d]``; with ``chosen``, the batched form, this rank's view taken
    from a store of only its host's views.  Returns the new state and the
    metrics as numpy, and the rank's full image."""
    state = trainer_mod.state_from_numpy(state_np, "cpu")
    sh = cfg.model.sh_degree
    if chosen is None:
        step = sharding.make_dp_train_step(cfg, width, height, sh, cfg.iterations, mesh)
        views = sharding.replicate_views(views_np, "cpu")
        state, metrics, image = step(state, views, sharding.shard_view_idx(idx, mesh))
    else:
        step = sharding.make_dp_train_step(cfg, width, height, sh, cfg.iterations, mesh,
                                           batched_views=True)
        nv = len(views_np["view"])
        local_ids = multihost.local_view_range(nv, mesh.data_index, mesh.shape["data"])
        store = {k: np.asarray(v)[local_ids] for k, v in views_np.items()}
        shards, _ = multihost.local_data_shards(mesh)
        batch = multihost.make_global_view_batch(
            multihost.select_local_batch(store, local_ids, np.asarray(chosen)[shards]),
            mesh, "cpu")
        state, metrics, image = step(state, batch)
    sharding.assert_replicated(state, mesh, "after the step")
    return {"state": trainer_mod.state_to_numpy(state),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "image": image.numpy()}


def steps(cfg, width, height, views_np, state_np, runs):
    """``runs``: (name, data, tile, idx, chosen) tuples, each one step from
    the same state on a mesh of its own over this group's ranks."""
    torch.set_num_threads(1)
    out = {}
    for name, data, tile, idx, chosen in runs:
        mesh = sharding.make_mesh(data, tile)
        out[name] = _step(cfg, width, height, views_np, state_np, mesh, idx, chosen)
    return out, {}


def trainer_run(cfg, data, point_cloud, state_np):
    """A Trainer of this group's ranks (``cfg.parallel``) from the state
    ``state_np``, drawing its own densify noise, run to ``cfg.iterations``.
    Returns the logged metrics, the final state, and every rank's own
    sequence of view ids and final noise key."""
    torch.set_num_threads(1)
    tr = trainer_mod.Trainer(cfg, data, point_cloud, device="cpu")
    tr.state = trainer_mod.state_from_numpy(state_np, "cpu")
    seen = []
    step = tr.train_step

    def recorded(state, views, idx):
        seen.append(int(idx))
        return step(state, views, idx)

    tr.train_step = recorded
    history = []
    tr.run(on_metrics=history.append)
    return ({"history": history, "state": trainer_mod.state_to_numpy(tr.state)},
            {"views": seen, "digest": sharding.state_digest(tr.state).tolist(),
             "key": tr.key.tolist()})
