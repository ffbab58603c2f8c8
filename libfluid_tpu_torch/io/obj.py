"""Wavefront OBJ export (reference ``mesh::save_obj``, ``mesh.h:56-99``); a
copy of ``libfluid_tpu.io.obj``, host numpy only.

Takes the mesher's fixed-capacity triangle soup; vertices are deduplicated
host-side (the reference dedups during extraction with rolling edge caches,
``mesher.cpp:394-407`` — a serial structure that has no place on TPU).

Face lines follow the reference exactly: plain ``f i j k`` without
attributes, ``f i/i`` with uvs only, ``f i/i/i`` (or ``f i//i``) with
normals — one shared index per vertex (``mesh.h:71-98``).
"""

from __future__ import annotations

import numpy as np


def dedup_triangles(vertices: np.ndarray, count: int, decimals: int = 6):
    """(T, 3, 3) soup -> (positions (V,3), indices (F,3))."""
    tris = np.asarray(vertices)[: int(count)].reshape(-1, 3)
    keys = np.round(tris, decimals)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    return uniq, inv.reshape(-1, 3)


def save_obj(path, vertices, count=None, normals=None, uvs=None, colors=None):
    """Write a triangle soup (or (V,3)+(F,3) pair) as OBJ.

    `normals` (V,3), `uvs` (V,2), `colors` (V,3) are per-vertex and share the
    position index, like the reference's parallel attribute arrays
    (``mesh.h:15-19``). Colors ride as the common nonstandard
    ``v x y z r g b`` extension.
    """
    vertices = np.asarray(vertices)
    if vertices.ndim == 3:
        n = vertices.shape[0] if count is None else int(count)
        pos, idx = dedup_triangles(vertices, n)
    else:
        pos, idx = vertices, np.asarray(count)
    has_n = normals is not None and len(normals)
    has_t = uvs is not None and len(uvs)
    has_c = colors is not None and len(colors)
    with open(path, "w") as f:
        for vi, p in enumerate(pos):
            if has_c:
                c = colors[vi]
                f.write(f"v {p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")
            else:
                f.write(f"v {p[0]} {p[1]} {p[2]}\n")
        if has_n:
            for nrm in normals:
                f.write(f"vn {nrm[0]} {nrm[1]} {nrm[2]}\n")
        if has_t:
            for uv in uvs:
                f.write(f"vt {uv[0]} {uv[1]}\n")
        # face layouts per mesh.h:71-98
        for t in idx:
            ids = [int(v) + 1 for v in t]
            if not has_n and not has_t:
                f.write(f"f {ids[0]} {ids[1]} {ids[2]}\n")
            elif not has_n:
                f.write("f " + " ".join(f"{i}/{i}" for i in ids) + "\n")
            else:
                mid = (lambda i: f"{i}") if has_t else (lambda i: "")
                f.write(
                    "f " + " ".join(f"{i}/{mid(i)}/{i}" for i in ids) + "\n"
                )


def load_obj(path):
    """Read positions/faces (and optional normals, uvs, colors) back.

    Returns (positions, indices) for plain files — the historical interface —
    via :func:`load_obj_full` which returns the attribute dict."""
    full = load_obj_full(path)
    return full["positions"], full["indices"]


def load_obj_full(path):
    pos, idx, nrm, uv, col = [], [], [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                pos.append([float(x) for x in parts[1:4]])
                if len(parts) >= 7:
                    col.append([float(x) for x in parts[4:7]])
            elif parts[0] == "vn":
                nrm.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vt":
                uv.append([float(x) for x in parts[1:3]])
            elif parts[0] == "f":
                idx.append([int(p.split("/")[0]) - 1 for p in parts[1:4]])
    return dict(
        positions=np.asarray(pos),
        indices=np.asarray(idx),
        normals=np.asarray(nrm) if nrm else None,
        uvs=np.asarray(uv) if uv else None,
        colors=np.asarray(col) if col else None,
    )
