"""The last data, checkpoint and profiling modules of the port against the
JAX package's, on the same seeds:

- ``data/transforms.py``: each transform of ``keys_to_transforms`` (the
  randomised ones from one ``random.Random`` seed in both packages) on the
  same PIL image, exact after the JAX NHWC output is transposed to CHW;
  each op of the UDA pool; ``min_max_resize``; ``denormalize``;
- ``data/device_transforms.py``: ``resize_matrix`` exact,
  ``device_preprocess`` within 1e-5;
- ``checkpoint/convert.py::convert_textpt_state_dict`` with and without a
  base table, exact, and its dict merged over a whole VLMo one, converted
  and loaded into a tiny VLMo;
- ``utils/profiling.py``: ``StepTimer.timeit``, ``hard_sync`` and ``trace``
  on CPU tensors.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import jax_params_of
from vqattack_tpu.checkpoint import convert as jconvert
from vqattack_tpu.data import device_transforms as jdev
from vqattack_tpu.data import transforms as jtr
from vqattack_tpu_torch import config as tcfg
from vqattack_tpu_torch import named_configs
from vqattack_tpu_torch.checkpoint import convert as tconvert
from vqattack_tpu_torch.checkpoint.synthetic import textpt_state_dict, vlmo_state_dict
from vqattack_tpu_torch.data import device_transforms as tdev
from vqattack_tpu_torch.data import transforms as ttr
from vqattack_tpu_torch.models.vlmo import VLMo, build_relative_position_index
from vqattack_tpu_torch.utils import profiling
from vqattack_tpu_torch.version import __version__

Image = pytest.importorskip("PIL.Image")
RANDOMISED = ("pixelbert_randaug", "square_transform_randaug")


def _image(seed: int, w: int = 72, h: int = 56):
    """A smooth random RGB image (a few draws, upsampled), so that the
    resizes and enhancements have structure to act on."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (h // 8, w // 8, 3), dtype=np.uint8)
    return Image.fromarray(small).resize((w, h), Image.BILINEAR)


@pytest.mark.parametrize("key", list(ttr._TRANSFORMS))
def test_each_registry_transform_matches_jax(key):
    """Each transform of the registry at size 64 on three images of
    different aspects (seeded alike in both packages where it draws): the
    port's CHW float32 equals the JAX NHWC output transposed."""
    for seed, (w, h) in enumerate(((72, 56), (48, 80), (64, 64))):
        kw = [{"rng": random.Random(seed)} for _ in range(2)] if key in RANDOMISED else [{}, {}]
        port = ttr._TRANSFORMS[key](size=64, **kw[0])
        ref = jtr._TRANSFORMS[key](size=64, **kw[1])
        for _ in range(3):  # three draws of the randomised transforms
            img = _image(seed, w, h)
            got, want = port(img), ref(img)
            assert got.dtype == np.float32 and got.shape == want.transpose(2, 0, 1).shape
            np.testing.assert_array_equal(got, want.transpose(2, 0, 1))


def test_keys_to_transforms_resolves_the_named_configs():
    """Every named config's transform keys resolve, in the JAX order."""
    keys = set()
    for name in named_configs.NAMED:
        cfg = named_configs.vlmo_named_config(name)
        keys.update(cfg["train_transform_keys"] + cfg["val_transform_keys"])
    assert keys and keys <= set(ttr._TRANSFORMS)
    fns = ttr.keys_to_transforms(sorted(keys), size=32)
    assert len(fns) == len(keys) and all(callable(f) for f in fns)
    img = _image(3)
    np.testing.assert_array_equal(ttr.keys_to_transforms(["square_transform"], size=32)[0](img),
                                  jtr.keys_to_transforms(["square_transform"], size=32)[0](img)
                                  .transpose(2, 0, 1))
    assert set(ttr._TRANSFORMS) == set(jtr._TRANSFORMS)


@pytest.mark.parametrize("i", range(len(jtr._UDA_POOL)))
def test_each_uda_op_matches_jax(i):
    """Op ``i`` of the pool at its m = 9 magnitude, from the same seed (the
    geometric ones draw their sign as they are applied)."""
    name, op, lo, hi = jtr._UDA_POOL[i]
    assert ttr._UDA_POOL[i] == (name, lo, hi)
    v = (9.0 / 30) * float(hi - lo) + lo
    for seed in (0, 1, 2, 3):
        img = _image(10 + seed)
        got = ttr._uda_op(name, img, v, random.Random(seed))
        want = op(img, v, random.Random(seed))
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_min_max_resize_and_denormalize_match_jax():
    for w, h, shorter, longer in ((72, 56, 64, 106), (40, 200, 64, 320), (200, 60, 64, 160)):
        img = _image(w, w, h)
        got, want = ttr.min_max_resize(img, shorter, longer), jtr.min_max_resize(img, shorter,
                                                                                 longer)
        assert got.size == want.size and got.size[0] % 32 == 0 == got.size[1] % 32
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    x = np.random.default_rng(0).uniform(-1.2, 1.2, (3, 8, 8)).astype(np.float32)
    np.testing.assert_array_equal(ttr.denormalize(x), jtr.denormalize(x))
    assert ttr.denormalize(x).dtype == np.uint8


def test_resize_matrix_and_device_preprocess_match_jax():
    """``resize_matrix`` bit for bit (up- and downsampling); the port's
    ``device_preprocess`` NCHW against the JAX NHWC within 1e-5."""
    for n_in, n_out in ((40, 32), (30, 32), (97, 24), (24, 24)):
        np.testing.assert_array_equal(tdev.resize_matrix(n_in, n_out),
                                      jdev.resize_matrix(n_in, n_out))
    raw = np.random.default_rng(0).integers(0, 256, (2, 40, 30, 3), dtype=np.uint8)
    got = tdev.device_preprocess(torch.from_numpy(raw), 32)
    assert got.shape == (2, 3, 32, 32) and got.dtype == torch.float32
    want = np.asarray(jdev.device_preprocess(jnp.asarray(raw), out_size=32))
    np.testing.assert_allclose(got.numpy(), want.transpose(0, 3, 1, 2), atol=1e-5)


# ---------------------------------------------------------- checkpoints


def _tiny_vlmo_cfg():
    cfg = tcfg.tiny_test_config().vlmo
    return dataclasses.replace(cfg, depth=2, vlffn_start_layer=1)


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


@pytest.mark.parametrize("with_base", [False, True], ids=["zeros", "base_table"])
def test_convert_textpt_state_dict_matches_jax(with_base):
    """A BEiT-style dict (the image side of the synthetic VLMo dict, with
    per-layer tables): the port's conversion equals the JAX one, key for
    key and bit for bit, over zeros or over a base table."""
    cfg = _tiny_vlmo_cfg()
    full = vlmo_state_dict(cfg, seed=0)
    beit = _np(textpt_state_dict(cfg, full, seed=1))
    table = full["relative_position_bias_table"].numpy()
    rows, cols = table.shape
    base = table if with_base else None
    got = tconvert.convert_textpt_state_dict(beit, rows, cols, base_table=base)
    want = jconvert.convert_textpt_state_dict(beit, rows, cols, base_table=base)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    merged = got["relative_position_bias_table"]
    img_rows = beit["blocks.0.attn.relative_position_bias_table"].shape[0]
    h = cfg.num_heads
    for i in range(cfg.depth):
        np.testing.assert_array_equal(merged[:img_rows, i * h:(i + 1) * h],
                                      beit[f"blocks.{i}.attn.relative_position_bias_table"])
    np.testing.assert_array_equal(merged[img_rows:], table[img_rows:] if with_base else 0.0)
    assert "transformer.blocks.1.mlp_imag.fc1.weight" in got
    assert "transformer.blocks.1.norm2_imag.weight" in got
    assert not any(".mlp." in k or ".norm2." in k for k in got)


def test_converted_textpt_dict_loads_into_vlmo():
    """The converted dict merged over a whole one, through ``convert_vlmo``
    into a tiny VLMo: the image expert, the shared trunk and the table are
    the BEiT file's; the text expert the whole dict's; the flax tree equals
    the JAX conversion's."""
    cfg = _tiny_vlmo_cfg()
    full = _np(vlmo_state_dict(cfg, seed=0, heads=("mlm_score", "itm_score", "itc", "itc_vl",
                                                    "vqa_classifier")))
    beit = _np(textpt_state_dict(cfg, {k: torch.from_numpy(v) for k, v in full.items()},
                                 seed=1))
    rows, cols = full["relative_position_bias_table"].shape
    merged = {**full, **tconvert.convert_textpt_state_dict(beit, rows, cols)}
    tree = tconvert.convert_vlmo(merged, depth=cfg.depth)
    jtree = jconvert.convert_vlmo({**full, **jconvert.convert_textpt_state_dict(beit, rows, cols)},
                                  depth=cfg.depth)
    model = tconvert.load_jax_params(VLMo(cfg), {"params": tree})
    np.testing.assert_array_equal(
        model.blocks[0].mlp_imag.fc1.weight.detach().numpy(), beit["blocks.0.mlp.fc1.weight"])
    np.testing.assert_array_equal(
        model.blocks[1].norm2_imag.weight.detach().numpy(), beit["blocks.1.norm2.weight"])
    np.testing.assert_array_equal(
        model.blocks[0].mlp_text.fc1.weight.detach().numpy(),
        full["transformer.blocks.0.mlp_text.fc1.weight"])
    np.testing.assert_array_equal(model.relative_position_bias_table.detach().numpy(),
                                  merged["relative_position_bias_table"])
    got, want = jax_params_of(model)["params"], jtree
    assert json.dumps(sorted(_paths(got))) == json.dumps(sorted(_paths(want)))
    for path in _paths(want):
        np.testing.assert_array_equal(_at(got, path), np.asarray(_at(want, path)))


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_textpt_rows_are_the_image_block_of_the_table():
    cfg = _tiny_vlmo_cfg()
    window = cfg.image_size // cfg.patch_size
    beit = textpt_state_dict(cfg, vlmo_state_dict(cfg, seed=0), seed=2)
    rows = beit["blocks.0.attn.relative_position_bias_table"].shape
    assert rows == ((2 * window - 1) ** 2 + 3, cfg.num_heads)
    assert rows[0] < build_relative_position_index((window, window), cfg.max_text_len)[
        "all_num_relative_distance"]
    assert not any(k.startswith("transformer.") or "_text" in k or "_vl" in k for k in beit)


# ------------------------------------------------------------ profiling


def test_step_timer_hard_sync_and_trace(tmp_path):
    calls = []

    def step(n):
        calls.append(n)
        return {"a": torch.ones(n), "b": (torch.zeros(2, 2), [torch.arange(3)]), "c": 1.5}

    timer = profiling.StepTimer()
    mean, out = timer.timeit(step, 4, warmup=2, reps=3)
    assert calls == [4] * 5 and torch.equal(out["a"], torch.ones(4))
    assert len(timer.times) == 1 and mean == timer.times[0] >= 0 and timer.mean == mean
    with timer:
        profiling.hard_sync(step(2))
    assert len(timer.times) == 2 and timer.mean == sum(timer.times) / 2
    profiling.hard_sync([torch.empty(0), torch.tensor(3.0)])
    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir)) as prof:
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    path = log_dir / profiling.TRACE_FILE
    assert path.exists() and "traceEvents" in json.loads(path.read_text())
    assert any("mm" in e.key for e in prof.key_averages())


def test_version():
    assert isinstance(__version__, str) and __version__.count(".") == 2
    import vqattack_tpu_torch

    assert vqattack_tpu_torch.__version__ == __version__
    assert os.path.basename(profiling.__file__) == "profiling.py"
