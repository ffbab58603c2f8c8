"""The harness finds what a later change adds as new files: a
configuration, a traffic mix, a per-layer metric's reader and a kernel's
roofline counts, named in BENCHMARK.json, with no file that is there
edited."""

import json
import shutil

from portbench import harness

READER = '''"""``frames_seen``: the frames of the window."""


def read(run):
    return len(run.frames)
'''

COUNTS = '''"""A kernel that no program has."""

SYMBOL, BF16 = "some_new_kernel", False


def measure(args):
    return {"bytes": 0}


def cost(m):
    return m["bytes"], 0.0
'''


def test_new_files_are_found(tree):
    pb = tree / "portbench"
    bench = json.loads((tree / "BENCHMARK.json").read_text())
    conf = json.loads((pb / "configs" / "small128.json").read_text())
    conf["sim"]["grid_size"] = [12, 12, 12]
    conf["seed_box"]["size"] = [5.0, 5.0, 5.0]
    (pb / "configs" / "added.json").write_text(json.dumps(conf))
    mix = json.loads((pb / "traffic" / "smallframes.json").read_text())
    mix.update(settle_frames=1, episode_frames=2)
    (pb / "traffic" / "added.json").write_text(json.dumps(mix))
    (pb / "metrics" / "frames_seen.py").write_text(READER)
    (pb / "roofline" / "some_new_kernel.py").write_text(COUNTS)
    shutil.copy(pb / "limits" / "small128.frames.json", pb / "limits" / "added.added.json")
    bench["configs"].append({"name": "added", "source": "a test", "file": "portbench/configs/added.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "added.added", "config": "added", "traffic": "added", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("added.added")
    bench["per_layer"].append({"name": "frames_seen", "unit": "count", "better": "higher",
                               "source": "program_counter", "layer": "a test", "moves": "frame_ms",
                               "workloads": ["added.added"]})
    (tree / "BENCHMARK.json").write_text(json.dumps(bench))

    b = harness.Bench(tree)
    assert "some_new_kernel" in b.roofline()
    result, _, _ = harness.run_cell(b, "added.added", 3, 0.0, True, device="cpu")
    assert result["metrics"]["frames_seen"]["value"] == result["attempted"]
    assert result["attempted"] >= 1
    untraced, _, _ = harness.run_cell(b, "added.added", 3, 0.0, False, device="cpu")
    assert set(untraced["metrics"]) == {"frame_ms", "setup_s"}
