"""Frame action "render": the persistent path tracer over the scene (the
megakernel with the accelerator), its draws seeded from the run's seed and
the frame's place in the episode.

A frame fails if the image is not finite or all black. Its answer is the
image, held to the reference's render of the program's mesh with the same
draws.
"""

import torch


def setup(f) -> None:
    f.rcfg = f.system.render_config(f.conf)


def render_seed(f) -> int:
    return (f.seed * 1000003 + f.k) % (1 << 62)


def run(f) -> None:
    f.image, f.rays = f.system.render(f.scene, f.cam, f.rcfg, render_seed(f))


def flags(f) -> dict:
    return {"image not finite": ~torch.isfinite(f.image).all(), "image all black": ~(f.image.amax() > 0)}


def values(f) -> dict:
    return {"rays": f.rays}


def capture(f, case: dict) -> None:
    case["image"] = f.image.detach().to("cpu", copy=True)
    case["render_seed"] = render_seed(f)


def compare(case: dict, ref) -> dict:
    return ref.render_frame(case["mesh"], case["image"], case["render_seed"])
