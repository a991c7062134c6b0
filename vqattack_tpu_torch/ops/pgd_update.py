"""The PGD L-inf update: kernel K1 and its plain version.

Port of ``vqattack_tpu/ops/pgd_update.py::pgd_linf_update``.  The kernel is
``csrc/pgd_update.cu``: one pass computing, per element,
``clip(ori + clip(clip(adv + eps_iter*sign(g), cmin, cmax) - ori, -eps, eps),
cmin, cmax)``.  :func:`pgd_linf_update_reference` is the same chain in plain
PyTorch: the CPU path, and the oracle the kernel must match bit for bit.
"""

from __future__ import annotations

import torch

from vqattack_tpu_torch.attacks.norms import LINF, clip_eta, optimize_linear
from vqattack_tpu_torch.ops import _build


def pgd_linf_update_reference(adv, grad, ori, eps, eps_iter, clip_min, clip_max):
    stepped = torch.clamp(adv + optimize_linear(grad, eps_iter, LINF), clip_min, clip_max)
    return torch.clamp(ori + clip_eta(stepped - ori, LINF, eps), clip_min, clip_max)


def pgd_linf_update(
    adv: torch.Tensor,
    grad: torch.Tensor,
    ori: torch.Tensor,
    eps: float,
    eps_iter: float,
    clip_min: float,
    clip_max: float,
) -> torch.Tensor:
    """Sign step + clamp + L-inf projection + clamp, shape-preserving.

    A CUDA tensor runs the kernel; a CPU tensor runs the plain version."""
    if adv.device.type == "cpu":
        return pgd_linf_update_reference(adv, grad, ori, eps, eps_iter, clip_min, clip_max)
    if adv.device.type != "cuda":
        raise ValueError(f"pgd_linf_update: unsupported device {adv.device}")
    for name, t in (("grad", grad), ("ori", ori)):
        if t.shape != adv.shape or t.device != adv.device:
            raise ValueError(f"pgd_linf_update: {name} {tuple(t.shape)} on {t.device} "
                             f"does not match adv {tuple(adv.shape)} on {adv.device}")
    for name, t in (("adv", adv), ("grad", grad), ("ori", ori)):
        if t.dtype != torch.float32:
            raise TypeError(f"pgd_linf_update: {name} is {t.dtype}; the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"pgd_linf_update: {name} is not contiguous")
    lib = _build.load()
    out = torch.empty_like(adv)
    with torch.cuda.device(adv.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.vq_pgd_linf_update(
            adv.data_ptr(), grad.data_ptr(), ori.data_ptr(), out.data_ptr(),
            adv.numel(), eps, eps_iter, clip_min, clip_max, stream,
        )
    _build.check(status, "pgd_linf_update")
    _build.count_launch(pgd_linf_update)
    return out


# launches of the kernel in this process (a plain count for chip_smoke.py)
pgd_linf_update.launches = 0
