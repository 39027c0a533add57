"""Each cell's entry at a tiny size on the CPU: the harness's run with the
look for a card skipped, the comparison, its control, and the faults that
``correct`` has to catch."""

import math
import time

import pytest
import torch

from bench_ranks import tiny
from benchlib import cells, compare, reference, session

SEED = 2 ** 31 + 77
ONE_CARD = [w["name"] for w in cells.manifest()["workloads"]
            if w["chips"] == 1]
SPATIAL = [w["name"] for w in cells.manifest()["workloads"]
           if cells.load(w["name"]).traffic.get("spatial_devices", 1) > 1]


def _run(name, seed=SEED, controls=False, batch=None):
    c = tiny(name)
    if batch:
        c = c._replace(traffic=dict(c.traffic, batch=batch))
    return c, session.run(None, c, seed, 0.0, False, time.time(),
                          device="cpu", controls=controls)


@pytest.mark.parametrize("name", ONE_CARD)
def test_cell_entry_and_its_control(name):
    """The program agrees with the reference at the tiny size; each control
    (the reference lower in precision in the program's place, on the
    configured reference's PCA bases) reads three times the program or
    more on some number, and the control proper (the nearest precision
    below the configuration's, the first) fails the cell's limits."""
    c, r = _run(name, controls=True)
    prog = r["readings"][c.config["conv_dtype"]]
    assert r["numbers"] == prog and prog["link_rel_rms"] == 0.0
    assert all(math.isfinite(v) for v in prog.values())
    print(name, r["readings"])
    controls = reference.CONTROLS[c.config["conv_dtype"]]
    for ctl_name in controls:
        ctl = r["readings"][ctl_name]
        assert max(ctl[k] / max(prog[k], 1e-30) for k in ctl) >= 3, \
            (ctl_name, prog, ctl)
    ctl = r["readings"][controls[0]]
    assert not compare.judge(ctl, {k: v for k, v in c.limits.items()
                                   if k in ctl}), (controls[0], ctl)


def _fault_unchanged(monkeypatch):
    from optimaltextures_tpu_torch import transport

    monkeypatch.setattr(transport, "transport_loop",
                        lambda gen, feature, *a, **k: feature)


def _fault_half_batch(monkeypatch):
    from optimaltextures_tpu_torch import transport

    orig = transport.transport_loop

    def half(gen, feature, *a, **k):
        h = feature.shape[0] // 2
        return torch.cat([orig(gen, feature[:h], *a, **k), feature[h:]])
    monkeypatch.setattr(transport, "transport_loop", half)


def _fault_answer(monkeypatch):
    from optimaltextures_tpu_torch import core

    orig = core._quant_u8

    def altered(x):
        u8 = orig(x)
        u8[0] = 255 - u8[0]
        return u8
    monkeypatch.setattr(core, "_quant_u8", altered)


@pytest.mark.parametrize("fault", [_fault_unchanged, _fault_half_batch,
                                   _fault_answer],
                         ids=["step_unchanged", "half_batch",
                              "answer_altered"])
@pytest.mark.parametrize("name", ONE_CARD)
def test_faults_make_correct_false(name, fault, monkeypatch):
    fault(monkeypatch)
    c, r = _run(name, batch=2)
    assert not compare.judge(r["numbers"], c.limits), r["numbers"]


@pytest.mark.parametrize("fault", ["none", "exchange"])
@pytest.mark.parametrize("name", SPATIAL)
def test_spatial_cell_and_a_missing_exchange(name, fault):
    """Two gloo ranks on the CPU: the sound run passes the cell's limits;
    with the halo exchange left out ``correct`` is false."""
    from optimaltextures_tpu_torch.parallel import mesh

    import bench_ranks

    r = mesh.spawn(bench_ranks.spatial_rank, 2, backend="gloo",
                   device="cpu", args=(name, SEED, fault), deadline_s=600)
    c = tiny(name)
    assert compare.judge(r["numbers"], c.limits) == (fault == "none"), \
        r["numbers"]
