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

# each cell of BENCHMARK.json and its copy at 16^3
SMALL = {"dam128.frames": "small128.frames", "dam64.render": "small64.render"}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """Skip the test without a CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: torch.cuda.is_available() is False")


def _small_config(conf: dict, n: int) -> dict:
    conf = json.loads(json.dumps(conf))
    conf["sim"].update(grid_size=[n, n, n], particle_capacity=8192)
    conf["seed_box"] = {"start": [1.0, 1.0, 1.0], "size": [n / 2 - 1.0] * 3}
    if "mesher" in conf:
        conf["mesher"].update(grid_size=[n, n, n], max_triangles=8192)
        conf["scene"].update(domain_max=[float(n)] * 3, accel_res=[n, n, n])
        conf["render"].update(width=16, height=16, samples_per_pixel=1)
    return conf


def make_tree(dst: Path, n: int = 16) -> Path:
    """A checkout of BENCHMARK.json and portbench/ in `dst` with a copy of
    each cell at n^3 (``SMALL``): the same actions and limits, 2 settle
    frames, episodes of 3, 2 frames compared, 1 profiled."""
    shutil.copy(ROOT / "BENCHMARK.json", dst)
    shutil.copytree(ROOT / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    pb = dst / "portbench"
    for cell in list(bench["workloads"]):
        small = SMALL[cell["name"]]
        cname, tname = "small" + cell["config"].removeprefix("dam"), "small" + cell["traffic"]
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
