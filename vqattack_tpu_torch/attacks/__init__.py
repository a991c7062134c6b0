"""The attack surface of ``vqattack_tpu/attacks/__init__.py``."""

from vqattack_tpu_torch.attacks.norms import clip_eta, optimize_linear  # noqa: F401
from vqattack_tpu_torch.attacks.pgd import (  # noqa: F401
    pgd_alternating,
    pgd_feature,
    pgd_multi_restart,
    pgd_vl_step,
    rand_init_eta,
)
from vqattack_tpu_torch.attacks.extra import (  # noqa: F401
    carlini_wagner_l2,
    fgm_classifier,
    momentum_iterative_method,
    noise,
    pgd_classifier,
    semantic,
    spsa,
)
