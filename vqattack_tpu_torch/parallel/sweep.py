"""The data-parallel attack sweep over the device mesh.

Port of ``vqattack_tpu/parallel/sweep.py``: thin wrappers over the one
batched engine, the lockstep bucketed attack of ``attacks/batched.py``
(``BatchedAlbefAttack``, ``BatchedVlmoAttack``), whose chunks shard over the
mesh's data axis, each replica cut over its row of the model axis where
that axis is above 1.  Every sample, with or without a paraphrase, runs inside
an ``(old_alg, k)`` bucket; none falls back to the one-at-a-time attack.
The CLI (``run.py --batch-size --mesh-devices``) builds the engine itself.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from vqattack_tpu_torch.attacks.pgd import pgd_feature
from vqattack_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, map_shards, shard_batch
from vqattack_tpu_torch.rng import RowsKey, clone_key


def batched_attack_step(loss_fns, pixels: torch.Tensor, ori_pixels: torch.Tensor, key,
                        aux: Dict[str, Any], mesh: Mesh, *, eps: float, eps_iter: float,
                        nb_iter: int, clip_min: float = -1.0, clip_max: float = 1.0,
                        rand_init: bool = False):
    """One feature-PGD run (:func:`~vqattack_tpu_torch.attacks.pgd.pgd_feature`)
    over a batch sharded on the mesh: ``pixels``, ``ori_pixels`` and each
    batch entry of ``aux`` ``[B, ...]`` cut into one row slice a data-axis
    device (``rel_biases`` whole on each), shard ``i`` driven by
    ``loss_fns[i]`` (a loss bound to that position's replica,
    ``parallel/mesh.py::shard_params``, cut over its row on a data x model
    mesh) on a host thread of its own, every draw made at the whole batch's
    size and sliced.  Returns ``(adv [B, ...], losses [nb_iter, B])`` on the first device."""
    b = pixels.shape[0]
    # VLMo's layer-stacked relative-position biases are batch-free: each
    # shard takes them whole (the JAX sweep replicates them)
    whole = {k: v for k, v in aux.items() if k == "rel_biases" and v is not None}
    shards = shard_batch({"x": pixels, "ori": ori_pixels,
                          "aux": {k: v for k, v in aux.items() if k not in whole}}, mesh)
    # an indivisible batch is one shard on the first device
    rows = b // len(shards)

    def run(i):
        sh = shards[i]
        device = sh["x"].device
        shard_aux = dict(sh["aux"], **{k: v.to(device) for k, v in whole.items()})
        shard_key = RowsKey(clone_key(key), i * rows, (i + 1) * rows, b, device)
        return pgd_feature(loss_fns[i], sh["x"], sh["ori"], shard_key, shard_aux, eps=eps,
                           eps_iter=eps_iter, nb_iter=nb_iter, clip_min=clip_min,
                           clip_max=clip_max, rand_init=rand_init)

    outs = map_shards(run, len(shards))
    first = mesh.devices[0]
    return (torch.cat([a.to(first) for a, _ in outs]),
            torch.cat([l.to(first) for _, l in outs], dim=1))


def make_sweep_runner(pipeline, mesh: Mesh, batch_size: Optional[int] = None
                      ) -> Callable[[list], Dict[str, Any]]:
    """A sweep over sample dicts through the lockstep engine on ``mesh``
    (chunks of ``batch_size``, by default the data axis).  The engine is the
    VLMo one for a pipeline with a ``model`` (``VlmoAttackPipeline``), the
    ALBEF one for a pipeline with a ``surrogate``.

    A sample is ``{qid, pixels [1, 3, H, W], question}`` (and optionally
    ``paraphrase``, ``target_answer``, ``all_correct_answers``).  Returns
    ``{qid: {adv_image, adv_text, losses, mlm_losses, substitutions}}``."""
    from vqattack_tpu_torch.attacks.batched import BatchedAlbefAttack, BatchedVlmoAttack

    bs = batch_size or mesh.shape[DATA_AXIS]
    engine = (BatchedAlbefAttack if hasattr(pipeline, "surrogate") else
              BatchedVlmoAttack)(pipeline, mesh=mesh)

    def run(samples: list) -> Dict[str, Any]:
        return {str(r.qid): {"adv_image": r.adv_image, "adv_text": r.adv_text,
                             "losses": r.feat_losses, "mlm_losses": r.mlm_losses,
                             "substitutions": r.substitutions}
                for r in engine.run(samples, batch_size=bs)}

    return run
