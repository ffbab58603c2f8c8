"""PPM image export (numpy copy of ``libfluid_tpu.io.ppm``)."""

from __future__ import annotations

import numpy as np
import torch


def save_ppm(path, image, gamma: float | None = None):
    """Write an (H, W, 3) float radiance image (a tensor on any device, or
    an array) as binary PPM (P6), clamped to [0, 1]; pass gamma (e.g. 2.2)
    for display-encoded output. The same bytes as the JAX package's writer."""
    if isinstance(image, torch.Tensor):
        image = image.detach().cpu().numpy()
    img = np.asarray(image, np.float64)
    if gamma:
        img = np.power(np.clip(img, 0.0, None), 1.0 / gamma)
    u8 = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    h, w, _ = u8.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(u8.tobytes())
