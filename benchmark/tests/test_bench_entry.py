"""The command as the driver runs it: without the CUDA devices a cell asks
for, or without the program beside the benchmark, it exits with another
code than 0 and prints no result."""

import os
import shutil
import subprocess
import sys

import pytest

from benchlib import cells


def _run(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "bf16-b128-chol",
         "--seed", str(2 ** 31 + 9), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    p = _run(cells.ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(os.path.join(cells.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(cells.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.parametrize("name", [w["name"] for w in
                                  cells.manifest()["workloads"]])
def test_every_cell_names_a_metric_reader_per_layer(name):
    from benchlib import cell

    for m in cells.load(name).per_layer:
        assert callable(cell.load_reader(m["name"]))
