"""Device selection for the port's entry points.

Every entry point runs on ``cuda`` unless the caller asks for ``"cpu"``
(the tests do).  With no card and no ``"cpu"`` request it raises: the port
never carries on quietly on the CPU.

Selecting a device also turns TF32 off for matrix products and cuDNN
convolutions, so float32 work runs in full float32 as the JAX trunk does.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
