"""``portbench/run.py`` without a card, and in a checkout that holds only
the benchmark: it exits with another code than 0 and prints no result."""

import json
import shutil
import subprocess
import sys

import torch

from conftest import ROOT


def _run(cwd, *extra):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "dam128.frames", "--seed",
                           "4294967297", "--seconds", "1", "--trace", "0", *extra], cwd=cwd,
                          capture_output=True, text=True, timeout=900)


def _prints_a_result(out: str) -> bool:
    lines = out.strip().splitlines()
    if not lines:
        return False
    try:
        return "correct" in json.loads(lines[-1])
    except ValueError:
        return False


def test_no_card_no_result():
    if torch.cuda.is_available():
        return  # the card's tests run the command on the card
    proc = _run(ROOT)
    assert proc.returncode != 0
    assert not _prints_a_result(proc.stdout)
    assert "no CUDA card" in proc.stderr


def test_only_the_benchmark_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert not _prints_a_result(proc.stdout)
