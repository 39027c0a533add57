"""On the card, at each cell's own size: the program passes its limits and
each control fails them, on three seeds. Marked ``cuda``; each test decides
inside itself whether the cards it needs are there.

    python -m pytest -m cuda benchmark/tests/test_bench_card.py"""

import time

import pytest

from benchlib import cell, cells, compare, reference

NAMES = [w["name"] for w in cells.manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_program_passes_and_control_fails_at_cell_size(name):
    import torch

    c = cells.load(name)
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        pytest.skip(f"needs {c.chips} CUDA device(s)")
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        r = cell.one_run(c, name, seed, 0.0, False, time.time(),
                         controls=True)
        prog = r["readings"][c.config["conv_dtype"]]
        assert compare.judge(prog, c.limits), (seed, prog)
        for ctl_name in reference.CONTROLS[c.config["conv_dtype"]]:
            ctl = r["readings"][ctl_name]
            assert not compare.judge(ctl, {k: v for k, v in c.limits.items()
                                           if k in ctl}), (seed, ctl_name, ctl)
