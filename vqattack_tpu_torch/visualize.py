"""Grad-CAM visualization CLI::

    python -m vqattack_tpu_torch.visualize --image img.jpg --question "what color..." \
        --vocab vocab.txt [--config cfg.json] [--surrogate-ckpt ALBEF.pth] [--layer 8] \
        [--out cam.png] [--alpha 0.5] [--device cpu]

Port of ``vqattack_tpu/visualize.py``: renders where the ALBEF fusion
encoder attends over the image patches when it encodes the question
(``utils/gradcam.py``'s probe) as a red heat-map overlay.  Without
``--surrogate-ckpt`` the surrogate has random weights from seed 0.  Runs on
``cuda`` unless ``--device cpu``; PIL, which reads and writes the images,
is imported only inside the functions that touch them.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="fusion cross-attention Grad-CAM")
    p.add_argument("--image", required=True)
    p.add_argument("--question", required=True)
    p.add_argument("--vocab", required=True)
    p.add_argument("--config", default=None)
    p.add_argument("--surrogate-ckpt", default=None)
    p.add_argument("--layer", type=int, default=8)
    p.add_argument("--out", default="gradcam.png")
    p.add_argument("--alpha", type=float, default=0.5, help="overlay opacity")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def overlay_heatmap(pixels_uint8: np.ndarray, cam: np.ndarray, alpha: float = 0.5):
    """``[H, W, 3]`` uint8 + ``[gh, gw]`` cam -> PIL image with a red heat
    overlay (the cam scaled to its maximum, resized bilinearly)."""
    from PIL import Image

    h, w = pixels_uint8.shape[:2]
    cam = cam / max(cam.max(), 1e-9)
    cam_img = Image.fromarray((cam * 255).astype(np.uint8)).resize((w, h), Image.BILINEAR)
    cam_arr = np.asarray(cam_img).astype(np.float32) / 255.0
    heat = np.zeros_like(pixels_uint8, dtype=np.float32)
    heat[..., 0] = cam_arr * 255  # red channel
    out = (1 - alpha * cam_arr[..., None]) * pixels_uint8 + alpha * cam_arr[..., None] * heat
    return Image.fromarray(np.clip(out, 0, 255).astype(np.uint8))


def read_image(path: str, size: int):
    """(``[size, size, 3]`` uint8 for the overlay, ``[1, 3, size, size]``
    float32 for the model) from an image file."""
    from PIL import Image

    from vqattack_tpu_torch.data.transforms import test_transform

    with Image.open(path) as img:
        img = img.convert("RGB")
        return np.asarray(img.resize((size, size))), test_transform(size)(img)[None]


def main(argv: Optional[list] = None) -> np.ndarray:
    args = build_argparser().parse_args(argv)

    from vqattack_tpu_torch import config as cfg_mod
    from vqattack_tpu_torch.device import resolve_device
    from vqattack_tpu_torch.models.albef import AlbefPretrain, init_weights
    from vqattack_tpu_torch.text.tokenizer import WordPieceTokenizer
    from vqattack_tpu_torch.utils.gradcam import albef_question_gradcam

    device = resolve_device(args.device)
    cfg = cfg_mod.load_config(args.config) if args.config else cfg_mod.albef_attack_config()
    tok = WordPieceTokenizer.from_file(args.vocab)
    raw, pixels = read_image(args.image, cfg.albef.vit.image_size)

    model = AlbefPretrain(cfg.albef).to(device)
    if args.surrogate_ckpt:
        from vqattack_tpu_torch.checkpoint import io as ckpt_io

        ckpt_io.load_albef_pretrain(args.surrogate_ckpt, cfg.albef, into=model)
    else:
        init_weights(model, seed=0)
    model.eval().requires_grad_(False)

    ids, mask = tok.encode(args.question, cfg.attack.max_text_len)
    cam = albef_question_gradcam(
        model, torch.from_numpy(pixels).to(device),
        torch.from_numpy(ids[None]).long().to(device),
        torch.from_numpy(mask[None]).long().to(device), layer=args.layer)[0]
    overlay_heatmap(raw, cam, args.alpha).save(args.out)
    print(f"wrote {args.out} (grid {cam.shape}, max {float(cam.max()):.4f})")
    return cam


if __name__ == "__main__":
    main()
