"""``--distributed`` and the objectives' ``group=`` on two gloo ranks.

Two processes with the environment ``python -m torch.distributed.run``
gives its ranks (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``; a free port a group) run a worker script that blocks any
import of JAX and drives the port alone.  In turn
they (1) take ``vlmo_pretrain_loss`` on their halves of a batch with
``group=`` (held against JAX's ``shard_map`` value, and their gradients
summed against the full batch's), (2) run the attack CLI with
``--distributed --device cpu`` at ``--batch-size 1`` and (3) at
``--batch-size 4 --pipeline-depth 2``, into one artifact directory each,
against single-process runs of the same arguments."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import ROOT, jax_params_of, synth_cli_assets, tiny_vlmo_configs
from vqattack_tpu.models.vlmo import VLMo as JVLMo
from vqattack_tpu.parallel.mesh import DATA_AXIS as J_DATA_AXIS
from vqattack_tpu.parallel.mesh import make_mesh as jmake_mesh
from vqattack_tpu.train.objectives import vlmo_pretrain_loss as j_vlmo_pretrain_loss
from vqattack_tpu_torch import config as tcfg
from vqattack_tpu_torch import run as port_run
from vqattack_tpu_torch.data import transforms
from vqattack_tpu_torch.data.vqa import VQADataset
from vqattack_tpu_torch.eval.metrics import all_reduce_mean
from vqattack_tpu_torch.models.vlmo import VLMo, init_vlmo_weights
from vqattack_tpu_torch.rng import TorchKey
from vqattack_tpu_torch.train.objectives import vlmo_pretrain_loss

WORLD = 2
B = 8
VOCAB = 64
MLM_ITC = {"mlm": 1, "itc": 1, "itm": 0}
# six questions on one image; 1002 is outside the attack subset, so the
# round robin over the raw stream gives rank 0 {1001, 1003, 1005} and rank
# 1 {1004, 1006} (counted after the subset filter it would give rank 0
# {1001, 1004, 1006})
CLI_SAMPLES = [(1001, "what color is the dog", "red", "the dog is red"),
               (1002, "what is the man holding", "frisbee", None),
               (1003, "what color is the cat", "blue", None),
               (1004, "what is the hat", "red", "the hat is red"),
               (1005, "what color is the dog", "blue", None),
               (1006, "what is the cat holding", "red", "the cat is holding red")]
RANK_QIDS = [["1001", "1003", "1005"], ["1004", "1006"]]

WORKER = r'''
import json, os, sys
for name in ("jax", "jaxlib", "flax", "vqattack_tpu"):
    sys.modules[name] = None  # any import of them raises ImportError
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
job = json.load(open(sys.argv[1]))
rank = int(os.environ["RANK"])
out = {"rank": rank}

# (1) the VLMo pretraining loss on this rank's half, group=WORLD
from vqattack_tpu_torch import config as tcfg
from vqattack_tpu_torch.eval.metrics import all_reduce_mean
from vqattack_tpu_torch.models.vlmo import VLMo, init_vlmo_weights
from vqattack_tpu_torch.rng import TorchKey
from vqattack_tpu_torch.train.objectives import vlmo_pretrain_loss

os.environ["MASTER_PORT"] = str(job["ports"][0])
dist.init_process_group("gloo", init_method="env://")
world = dist.get_world_size()
model = init_vlmo_weights(VLMo(tcfg.load_config(job["config"]).vlmo), seed=0)
data = np.load(job["batch"])
n = data["pixels"].shape[0] // world
batch = {k: torch.from_numpy(data[k][rank * n:(rank + 1) * n]) for k in data.files}
loss, _ = vlmo_pretrain_loss(model, batch, TorchKey(7, "cpu"), weights=job["weights"],
                             group=dist.group.WORLD)
(loss / world).backward()
out["loss"] = float(loss)
np.savez(job["grads"] % rank, **{k: p.grad.numpy() for k, p in model.named_parameters()
                                 if p.grad is not None})
itm, _ = vlmo_pretrain_loss(model, batch, TorchKey(7 + rank, "cpu"),
                            weights={"itm": 1, "itc": 0, "mlm": 0}, group=dist.group.WORLD)
out["itm"] = float(itm)
out["mean"] = all_reduce_mean([rank + 1.0] * (rank + 1))
dist.destroy_process_group()

# (2), (3) the attack CLI, one group each
from vqattack_tpu_torch import run
from vqattack_tpu_torch.attacks import orchestrator

save = orchestrator.save_artifacts
out["qids"] = []
def recorded(results, *a, **kw):
    out["qids"].append([r.qid for r in results])
    return save(results, *a, **kw)
orchestrator.save_artifacts = recorded
out["summaries"] = []
for port, argv in zip(job["ports"][1:], job["cli"]):
    os.environ["MASTER_PORT"] = str(port)
    out["summaries"].append(run.main(argv + ["--distributed"]))
json.dump(out, open(job["out"] % rank, "w"))
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _vlmo_cfg():
    _, tc = tiny_vlmo_configs(VOCAB, depth=2)
    return tc


def _pretrain_batch():
    cfg = _vlmo_cfg().vlmo
    rng = np.random.default_rng(0)
    ids = rng.integers(4, 60, (B, cfg.max_text_len)).astype(np.int64)
    ids[:, 0] = 2
    mlm_ids = ids.copy()
    mlm_ids[:, 3] = 4
    labels = np.full_like(ids, -100)
    labels[:, 3] = 5
    # exactly one masked position a row: the ranks' MLM means average to
    # the whole batch's
    return {"pixels": rng.uniform(-1, 1, (B, 3, 32, 32)).astype(np.float32), "text_ids": ids,
            "text_mask": np.ones_like(ids), "mlm_ids": mlm_ids, "mlm_labels": labels}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' outputs, and the single-process CLI runs."""
    tmp = tmp_path_factory.mktemp("ranks")
    cfg_path = tmp / "vlmo.json"
    tcfg.save_config(_vlmo_cfg(), str(cfg_path))
    np.savez(tmp / "batch.npz", **_pretrain_batch())
    argv = synth_cli_assets(tmp, CLI_SAMPLES)
    (tmp / "right.txt").write_text("".join(f"{q}\n" for q, *_ in CLI_SAMPLES if q != 1002))
    runs = {"b1": [], "b4": ["--batch-size", "4", "--pipeline-depth", "2"]}
    cli, single = [], {}
    for name, flags in runs.items():
        base = [a if a != str(tmp / "out") else str(tmp / f"out_{name}") for a in argv]
        cli.append(base + flags + ["--seed", "5"])
        single_argv = [a if a != str(tmp / "out") else str(tmp / f"single_{name}") for a in argv]
        single[name] = port_run.main(single_argv + flags + ["--seed", "5"])
    job = {"config": str(cfg_path), "batch": str(tmp / "batch.npz"), "weights": MLM_ITC,
           "grads": str(tmp / "grads%d.npz"), "out": str(tmp / "rank%d.json"),
           "ports": [_free_port() for _ in range(3)], "cli": cli}
    (tmp / "job.json").write_text(json.dumps(job))
    (tmp / "worker.py").write_text(WORKER)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", MASTER_ADDR="localhost",
               WORLD_SIZE=str(WORLD))
    procs = [subprocess.Popen([sys.executable, str(tmp / "worker.py"), str(tmp / "job.json")],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=str(tmp),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    outs = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(WORLD)]
    return tmp, outs, single, logs


def test_ranks_announce_themselves_and_import_no_jax(ranks):
    _, outs, _, logs = ranks
    for r, log in enumerate(logs):
        # one group for the loss, one a CLI run; the CLI's on the CPU, gloo
        assert log.count(f"rank {r} of {WORLD}: device cpu, backend gloo") == 2
    assert [o["rank"] for o in outs] == [0, 1]


def test_vlmo_pretrain_loss_under_a_group_matches_jax_shard_map_and_the_full_batch(ranks):
    """MLM + ITC: each rank's loss against the JAX loss of its shard under
    ``shard_map`` over a 2-device mesh (``axis_name``), test_parallel's
    rtol 2e-5 and atol 1e-6; their mean against the full batch on one
    process; each rank differentiating its share of the mean over ranks,
    the ranks' gradients summed against the full batch's; ITM under the
    group finite; ``all_reduce_mean`` over the ranks' values."""
    from jax.sharding import PartitionSpec as P

    tmp, outs, _, _ = ranks
    batch = _pretrain_batch()
    t_model = init_vlmo_weights(VLMo(_vlmo_cfg().vlmo), seed=0)
    jc, _ = tiny_vlmo_configs(VOCAB, depth=2)
    j_model = JVLMo(jc.vlmo)
    params = jax_params_of(t_model)
    jbatch = {k: jnp.asarray(v.transpose(0, 2, 3, 1) if k == "pixels" else v)
              for k, v in batch.items()}
    mesh = jmake_mesh(WORLD)

    @jax.jit
    def per_shard(p, bt):
        def fn(shard):
            loss, _ = j_vlmo_pretrain_loss(j_model, p, shard, jax.random.key(0), weights=MLM_ITC,
                                           axis_name=J_DATA_AXIS)
            return loss[None]

        return jax.shard_map(fn, mesh=mesh, in_specs=({k: P(J_DATA_AXIS) for k in bt},),
                             out_specs=P(J_DATA_AXIS), check_vma=False)(bt)

    want = np.asarray(per_shard(params, jbatch))
    got = np.array([o["loss"] for o in outs])
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)

    full, _ = vlmo_pretrain_loss(t_model, {k: torch.from_numpy(v) for k, v in batch.items()},
                                 TorchKey(7, "cpu"), weights=MLM_ITC)
    np.testing.assert_allclose(got.mean(), full.item(), rtol=2e-5, atol=1e-6)
    full.backward()
    grads = [np.load(tmp / f"grads{r}.npz") for r in range(WORLD)]
    n_checked = 0
    for name, p in t_model.named_parameters():
        if p.grad is None:
            continue
        summed = sum(g[name] for g in grads)
        scale = max(1.0, float(np.abs(p.grad.numpy()).max()))
        np.testing.assert_allclose(summed, p.grad.numpy(), rtol=2e-5, atol=1e-6 * scale,
                                   err_msg=name)
        n_checked += 1
    assert n_checked > 20
    assert all(np.isfinite(o["itm"]) for o in outs)
    # rank 0 holds [1.0], rank 1 [2.0, 2.0]: the mean of all three
    assert all(o["mean"] == pytest.approx(5.0 / 3.0) for o in outs)
    assert all_reduce_mean([1.0, 2.0]) == 1.5 and all_reduce_mean([]) == 0.0


def test_round_robin_over_the_raw_stream_and_batch1_union_bit_for_bit(ranks):
    """At ``--batch-size 1`` each rank attacks every second item of the raw
    stream from its rank, counted before the subset filter, and the union
    of the two ranks' artifacts equals one process's bit for bit (every
    sample's key is folded by its qid); the text JSON holds the union."""
    tmp, outs, single, _ = ranks
    assert [o["qids"][0] for o in outs] == RANK_QIDS
    for r, o in enumerate(outs):
        s = o["summaries"][0]
        assert (s["rank"], s["world_size"], s["samples"]) == (r, WORLD, len(RANK_QIDS[r]))
        assert s["samples_all_ranks"] == single["b1"]["samples"] == 5
    qids = sorted(q for qs in RANK_QIDS for q in qs)
    for q in qids:
        a = np.load(tmp / "out_b1" / f"{q}.npy")
        b = np.load(tmp / "single_b1" / f"{q}.npy")
        assert a.dtype == b.dtype and np.array_equal(a, b), q
        assert torch.equal(torch.load(tmp / "out_b1" / f"{q}.pt"),
                           torch.load(tmp / "single_b1" / f"{q}.pt"))
    texts = json.loads((tmp / "out_b1" / "adv_txt_dict.json").read_text())
    assert texts == json.loads((tmp / "single_b1" / "adv_txt_dict.json").read_text())
    assert sorted(texts) == qids


def test_batched_union_and_the_text_dict_of_concurrent_writers(ranks):
    """At ``--batch-size 4 --pipeline-depth 2`` the ranks' qids are
    disjoint and their union is the single run's; the text JSON both ranks
    wrote at the end of their runs holds every qid; every image stays in
    the eps ball of its clean image and in [-1, 1]."""
    tmp, outs, single, _ = ranks
    per_rank = [o["qids"][1] for o in outs]
    assert [sorted(q) for q in per_rank] == RANK_QIDS
    union = sorted(q for qs in per_rank for q in qs)
    assert len(union) == len(set(union)) == single["b4"]["samples"] == 5
    texts = json.loads((tmp / "out_b4" / "adv_txt_dict.json").read_text())
    assert sorted(texts) == union
    cfg = tcfg.load_config(str(tmp / "cfg.json"))
    clean = VQADataset([str(tmp / "ann.json")], str(tmp),
                       transforms.test_transform(cfg.albef.vit.image_size))[0]["pixels"]
    for q in union:
        adv = np.load(tmp / "out_b4" / f"{q}.npy").transpose(0, 3, 1, 2)
        assert np.abs(adv - clean).max() <= cfg.attack.eps + 1e-6
        assert np.abs(adv).max() <= 1.0
    assert sorted(os.listdir(tmp / "out_b4")) == sorted(
        [f"{q}{ext}" for q in union for ext in (".npy", ".pt")] + ["adv_txt_dict.json"])


def test_distributed_and_mesh_refusals(tmp_path, monkeypatch):
    """``--distributed`` without the launcher's variables exits, and with
    ``--mesh-devices`` too; a mesh of cards larger than the cards present
    (none here) raises; the default sample stream reads through
    ``iter_batches``."""
    argv = synth_cli_assets(tmp_path, CLI_SAMPLES[:2])
    for k in port_run._LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit, match="RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, "
                                         "MASTER_PORT not set"):
        port_run.main(argv + ["--distributed"])
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                     MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match="one or the other"):
        port_run.main(argv + ["--distributed", "--batch-size", "2", "--mesh-devices", "2"])
    args = port_run.build_argparser().parse_args(argv + ["--batch-size", "2",
                                                         "--mesh-devices", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_run._mesh(args, torch.device("cuda"))
    assert port_run._mesh(args, torch.device("cpu")).shape["data"] == 2
    one = port_run.build_argparser().parse_args(argv + ["--mesh-devices", "2"])
    assert port_run._mesh(one, torch.device("cpu")) is None  # batch 1: no engine, no mesh

    read = []
    real = VQADataset.iter_batches
    monkeypatch.setattr(VQADataset, "iter_batches",
                        lambda self, *a, **kw: read.append(a) or real(self, *a, **kw))
    summary = port_run.main(argv + ["--batch-size", "2", "--mesh-devices", "2",
                                    "--output", str(tmp_path / "mesh")])
    assert summary["samples"] == 2 and [list(a[0]) for a in read] == [[0, 1]]
