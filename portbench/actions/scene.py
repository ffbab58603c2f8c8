"""Frame action "scene": the water mesh injected into the fluid box
(``inject_mesh``) and the uniform-grid accelerator built over the scene
(``accel.build``).

A frame fails if the accelerator's list of large triangles overflowed. The
accelerator is judged through the image it renders.
"""


def setup(f) -> None:
    f.scene0, f.cam, f.water = f.system.base_scene(f.conf)


def run(f) -> None:
    f.scene = f.system.scene(f.scene0, f.mesh, f.water, f.conf["scene"]["accel_res"])


def flags(f) -> dict:
    return {"accelerator overflowed": f.scene.accel.big_overflow > 0}


def values(f) -> dict:
    return {}


def capture(f, case: dict) -> None:
    pass


def compare(case: dict, ref) -> dict:
    return {}
