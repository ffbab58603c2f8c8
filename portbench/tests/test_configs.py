"""What a configuration file may say beyond the two cells' files: several
seed boxes, and "sim" keys of the port's own that the frozen reference does
not declare, each named in ``"program_only"``; and that the small copies of
the tests take a cell that uses them (16^3, on the CPU)."""

import json
import shutil

import pytest
import torch

from portbench import harness
from portbench.reference import state_io
from portbench.system import Program
from conftest import ROOT, _small_config, make_tree

FLOOR = {"start": [1.0, 1.0, 1.0], "size": [14.0, 2.0, 14.0]}
WALL = {"start": [1.0, 3.0, 1.0], "size": [3.0, 8.0, 14.0]}
# BASELINE.json config 5's tide: a shallow floor and a wall of water, 256^3
TIDE_BOXES = [{"start": [1.0, 1.0, 1.0], "size": [254.0, 9.0, 254.0]},
              {"start": [1.0, 10.0, 1.0], "size": [24.0, 63.0, 254.0]}]


def small_conf(**boxes) -> dict:
    conf = _small_config(json.loads((ROOT / "portbench" / "configs" / "dam128.json").read_text()), 16)
    del conf["seed_box"]
    conf.update(boxes)
    return conf


def seeded(conf: dict, seed: int = 2**31 + 5):
    program = Program("cpu")
    return program.seeded_state(program.sim_config(conf), conf, seed)


def test_two_boxes_seed_the_sum_of_their_counts_in_order():
    floor, wall = seeded(small_conf(seed_box=FLOOR)), seeded(small_conf(seed_box=WALL))
    both = seeded(small_conf(seed_boxes=[FLOOR, WALL]))
    n_floor, n_wall = int(floor.active.sum()), int(wall.active.sum())
    assert n_floor > 0 and n_wall > 0
    assert int(both.active.sum()) == n_floor + n_wall
    assert bool(both.active[: n_floor + n_wall].all())
    # the floor first, with the jitter that the floor alone draws; the wall after it
    assert torch.equal(both.position[:n_floor], floor.position[:n_floor])
    wall_rows = both.position[n_floor: n_floor + n_wall]
    assert bool((wall_rows[:, 1] > 3.0).all() & (wall_rows[:, 0] < 4.0).all())
    assert bool((floor.position[:n_floor, 1] < 3.0).all())


def test_one_box_in_a_list_seeds_as_the_seed_box():
    one, listed = seeded(small_conf(seed_box=FLOOR)), seeded(small_conf(seed_boxes=[FLOOR]))
    assert torch.equal(one.active, listed.active)
    assert torch.equal(one.position, listed.position)


def test_both_keys_are_refused():
    with pytest.raises(ValueError, match="not both"):
        seeded(small_conf(seed_box=FLOOR, seed_boxes=[WALL]))


def test_a_key_the_reference_lacks_raises_unless_the_configuration_names_it():
    conf = small_conf(seed_box=FLOOR)
    plain = state_io.sim_config(conf)
    conf["sim"]["slab_count"] = 4
    assert state_io.program_keys(conf) == []
    with pytest.raises(TypeError, match="slab_count"):
        state_io.sim_config(conf)
    conf["program_only"] = ["slab_count"]
    assert state_io.program_keys(conf) == ["slab_count"]
    assert state_io.sim_config(conf) == plain
    with pytest.raises(TypeError, match="slab_count"):
        Program("cpu").sim_config(conf)


def test_a_key_the_reference_declares_is_never_left_to_the_program():
    conf = small_conf(seed_box=FLOOR)
    conf["program_only"] = ["slab_count", "correction_capacity"]
    with pytest.raises(ValueError, match="correction_capacity"):
        state_io.sim_config(conf)


class Slabbed(Program):
    """A port whose ``SimConfig`` takes a slab count (which changes how it
    computes, not what)."""

    def sim_config(self, conf):
        conf = json.loads(json.dumps(conf))
        assert conf["sim"].pop("slab_count") == 4
        return super().sim_config(conf)


def test_a_run_with_a_key_of_the_port_is_held_to_the_reference(tree):
    path = tree / "portbench" / "configs" / "small128.json"
    conf = json.loads(path.read_text())
    conf["sim"]["slab_count"] = 4
    conf["program_only"] = ["slab_count"]
    path.write_text(json.dumps(conf))
    logged = []
    result, checks, _ = harness.run_cell(harness.Bench(tree), "small128.frames", 2**31 + 17, 0.0, False,
                                         device="cpu", system=Slabbed("cpu"), log=logged.append)
    assert result["correct"], checks
    assert any("['slab_count'] are left to the program" in line for line in logged), logged


def test_a_third_cell_with_two_seed_boxes(tmp_path):
    """A checkout with a 256^3 two-box trial cell beside the two cells: its
    small copy holds both boxes inside the small grid, and runs correct."""
    src, dst = tmp_path / "src", tmp_path / "dst"
    src.mkdir()
    dst.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", src)
    shutil.copytree(ROOT / "portbench", src / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    pb = src / "portbench"
    conf = json.loads((pb / "configs" / "dam128.json").read_text())
    del conf["seed_box"]
    conf["seed_boxes"] = TIDE_BOXES
    conf["sim"].update(grid_size=[256, 256, 256], particle_capacity=1 << 23)
    (pb / "configs" / "tide256.json").write_text(json.dumps(conf))
    shutil.copy(pb / "limits" / "dam128.frames.json", pb / "limits" / "tide256.frames.json")
    bench = json.loads((src / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tide256", "source": "a test", "file": "portbench/configs/tide256.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tide256.frames", "config": "tide256", "traffic": "frames",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("tide256.frames")
    (src / "BENCHMARK.json").write_text(json.dumps(bench))

    make_tree(dst, src=src)
    small = json.loads((dst / "portbench" / "configs" / "smalltide256.json").read_text())
    assert small["sim"]["grid_size"] == [16, 16, 16]
    assert len(small["seed_boxes"]) == 2
    for box in small["seed_boxes"]:
        assert all(1.0 <= s and s + z <= 15.0 for s, z in zip(box["start"], box["size"]))
    result, checks, _ = harness.run_cell(harness.Bench(dst), "smalltide256.frames", 2**31 + 23, 0.0, False,
                                         device="cpu")
    assert result["correct"], checks
    assert result["failed"] == 0
