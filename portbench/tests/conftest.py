"""Fixtures of the benchmark's own tests: a copy of the benchmark's files
with its cells cut to a size the CPU runs in seconds, and the card check.

Run from the repository's root: ``python -m pytest portbench/tests -q``.
Tests marked ``card`` skip without a CUDA card; on the card they run with
the others.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.system import seed_boxes  # noqa: E402


def small_names(cell: dict) -> tuple:
    """The names of a cell's small copy, derived from its own: (the cell,
    its configuration, its traffic mix)."""
    cname, tname = "small" + cell["config"].removeprefix("dam"), "small" + cell["traffic"]
    return f"{cname}.{cell['traffic']}", cname, tname


# each cell of BENCHMARK.json and its copy at 16^3
SMALL = {w["name"]: small_names(w)[0] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """Skip the test without a CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: torch.cuda.is_available() is False")


def small_box(box: dict, big, n: int) -> dict:
    """A seed box of a grid of `big` cells (per axis) moved into a grid of
    n: each axis's interior, 1 to big - 1, mapped onto 1 to n - 1."""
    def at(x, m):
        return 1.0 + (x - 1.0) * (n - 2) / (m - 2)

    start = [at(s, m) for s, m in zip(box["start"], big)]
    end = [at(s + z, m) for s, z, m in zip(box["start"], box["size"], big)]
    return {"start": start, "size": [e - s for s, e in zip(start, end)]}


def _small_config(conf: dict, n: int) -> dict:
    conf = json.loads(json.dumps(conf))
    boxes = [small_box(box, conf["sim"]["grid_size"], n) for box in seed_boxes(conf)]
    if "seed_boxes" in conf:
        conf["seed_boxes"] = boxes
    else:
        conf["seed_box"] = boxes[0]
    conf["sim"].update(grid_size=[n, n, n], particle_capacity=8192)
    if "mesher" in conf:
        conf["mesher"].update(grid_size=[n, n, n], max_triangles=8192)
        conf["scene"].update(domain_max=[float(n)] * 3, accel_res=[n, n, n])
        conf["render"].update(width=16, height=16, samples_per_pixel=1)
    return conf


def make_tree(dst: Path, n: int = 16, src: Path = ROOT) -> Path:
    """A checkout of `src`'s BENCHMARK.json and portbench/ in `dst` with a
    copy of each cell at n^3 (named by :func:`small_names`): the same
    actions and limits, its seed boxes moved into the small grid, 2 settle
    frames, episodes of 3, 1 frame profiled."""
    shutil.copy(src / "BENCHMARK.json", dst)
    shutil.copytree(src / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    pb = dst / "portbench"
    for cell in list(bench["workloads"]):
        small, cname, tname = small_names(cell)
        if not (pb / "configs" / f"{cname}.json").exists():
            entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
            conf = _small_config(json.loads((dst / entry["file"]).read_text()), n)
            (pb / "configs" / f"{cname}.json").write_text(json.dumps(conf))
            bench["configs"].append(dict(entry, name=cname, file=f"portbench/configs/{cname}.json"))
        if not (pb / "traffic" / f"{tname}.json").exists():
            mix = json.loads((pb / "traffic" / f"{cell['traffic']}.json").read_text())
            mix.update(settle_frames=2, episode_frames=3,
                       profile=dict(mix["profile"], frames=1))
            (pb / "traffic" / f"{tname}.json").write_text(json.dumps(mix))
        shutil.copy(pb / "limits" / f"{cell['name']}.json", pb / "limits" / f"{small}.json")
        bench["workloads"].append(dict(cell, name=small, config=cname, traffic=tname))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if cell["name"] in m.get("workloads", []):
                m["workloads"].append(small)
    (dst / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dst


@pytest.fixture
def tree(tmp_path):
    return make_tree(tmp_path)
