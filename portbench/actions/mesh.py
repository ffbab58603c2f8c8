"""Frame action "mesh": ``generate_mesh`` of the particles after the step
(the surface sampled on the mesher's nodes, then marching cubes).

A frame fails if the mesh fills its triangle capacity. Its answer is the
mesh, held to the reference's mesh of the same state.
"""

from portbench.hostcopy import to_host


def setup(f) -> None:
    f.mcfg = f.system.mesher_config(f.conf)


def run(f) -> None:
    f.mesh = f.system.mesh(f.state, f.mcfg)


def flags(f) -> dict:
    return {"mesh at its triangle capacity": f.mesh.count >= f.mcfg.max_triangles}


def values(f) -> dict:
    return {"triangles": f.mesh.count}


def capture(f, case: dict) -> None:
    case["mesh"] = {"vertices": to_host(f.mesh.vertices), "count": int(f.mesh.count)}


def compare(case: dict, ref) -> dict:
    return ref.mesh_frame(case["post"], case["mesh"])
