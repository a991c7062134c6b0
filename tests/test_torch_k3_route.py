"""Which K3 instance each call takes (``ops/attention.py::k3_route``).

The float32 kernels are the Hopper ones (``csrc/flash_attention_tf32.cu``)
at both head dims, head dim 34 read through the folded map's 40-column
boxes; the bias gradient keeps ``csrc/flash_attention.cu``'s mma.sync dQ
kernel beside the Hopper dK/dV kernel.  The bf16 kernels
(``csrc/flash_attention_bf16.cu``) take both head dims too, head dim 34
through the folded map's 64-column boxes, with no pad copy: a tensor the
map does not take is copied into packed rows and counted on the entry
point (``hd34_copy_launches``), in either dtype.  Runs on the CPU: no
kernel is launched and nothing of JAX is compiled.
"""

from __future__ import annotations

import pytest
import torch

from vqattack_tpu_torch.ops import _build, attention

ROUTES = {
    (torch.float32, 64, False): "tf32_wgmma",
    (torch.float32, 64, True): "tf32_wgmma_dbias",
    (torch.float32, 34, False): "tf32_wgmma",
    (torch.float32, 34, True): "tf32_wgmma_dbias",
    (torch.bfloat16, 64, False): "bf16_wgmma",
    (torch.bfloat16, 34, False): "bf16_wgmma",  # the folded map, no pad copy
}


@pytest.mark.parametrize("dtype,head_dim,dbias", list(ROUTES))
def test_each_call_takes_its_declared_instance(dtype, head_dim, dbias):
    route = attention.k3_route(dtype, head_dim, dbias)
    assert route == ROUTES[dtype, head_dim, dbias]
    source = attention.K3_ROUTES[route]
    assert source.startswith("vqattack_tpu_torch/csrc/")
    assert source.rsplit("/", 1)[1] in _build.SOURCES


def test_every_declared_instance_is_reached():
    """No instance is declared that no (dtype, head dim, dbias) takes."""
    assert set(ROUTES.values()) == set(attention.K3_ROUTES)


@pytest.mark.parametrize("dtype,head_dim,dbias,error", [
    (torch.bfloat16, 64, True, ValueError),  # no bf16 dbias
    (torch.float32, 40, False, ValueError),  # the bf16 row width is no head dim
    (torch.float32, 128, False, ValueError),
    (torch.float16, 64, False, TypeError),
])
def test_what_no_instance_takes_is_refused(dtype, head_dim, dbias, error):
    with pytest.raises(error):
        attention.k3_route(dtype, head_dim, dbias)


@pytest.mark.parametrize("dtype,head_dim,key_bias,dbias,counts", [
    (torch.float32, 64, False, False, ("launches", "tf32_wgmma_launches")),
    (torch.float32, 64, True, True, ("launches", "key_bias_launches", "tf32_wgmma_launches")),
    (torch.float32, 34, True, False,
     ("launches", "key_bias_launches", "hd34_launches", "tf32_wgmma_launches")),
    (torch.bfloat16, 64, False, False, ("bf16_launches",)),
    (torch.bfloat16, 34, True, False,
     ("bf16_launches", "bf16_key_bias_launches", "bf16_hd34_launches")),
])
def test_launch_counts_follow_the_route(dtype, head_dim, key_bias, dbias, counts):
    """Every float32 launch, at head dim 34 too, is counted as one of the
    Hopper kernels (``tf32_wgmma_launches``), which ``chip_smoke.py`` holds
    against all float32 launches of each batched run."""
    kb = torch.zeros(1, 8) if key_bias else None
    assert attention._counts(dtype, kb, head_dim, dbias) == counts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_head_dim_34_copies_are_counted_on_the_entry_point(dtype, direction):
    """A q/k/v tensor at head dim 34 that the folded map does not take (its
    base off 16 bytes) is copied once and counted in the entry point's
    ``hd34_copy_launches``, in either dtype; a projection view is read in
    place and adds nothing."""
    fn = getattr(attention, f"flash_attention_{direction}")
    before = fn.hd34_copy_launches
    view = torch.zeros(2, 5, 16 * 34, dtype=dtype).view(2, 5, 16, 34)
    assert attention.folded_or_copied(view, fn) is view
    assert fn.hd34_copy_launches == before
    off = torch.zeros(2, 5, 16 * 34 + 1, dtype=dtype)[..., 1:].view(2, 5, 16, 34)
    copy = attention.folded_or_copied(off, fn)
    assert copy is not off and torch.equal(copy, off) and attention.fits_folded_box(copy)
    assert fn.hd34_copy_launches == before + 1
    fn.hd34_copy_launches = before
