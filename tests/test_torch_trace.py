"""The port's spans (``utils/trace.py``) on the CPU: the span tree a run
records under ``torch.profiler``, its leaves tiling the run's ops, the
``optex.run`` args, the helper's no-op when no profiler is on, and runs
bit-equal with the profiler on and off."""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from optimaltextures_tpu_torch import config as tconfig
from optimaltextures_tpu_torch import core as tcore
from optimaltextures_tpu_torch.utils import imageio, trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "docs", "samples", "graffiti_cholhist_256.png")
DEPTH = 2
STAGE_LEAVES = ("optex.encode", "optex.project", "optex.rotations",
                "optex.ot_steps", "optex.unproject", "optex.decode")
# (config, batch, prefetch budget): cdf and chol as the CLI runs them, chol
# in two chunks, and the low-memory prep (each pass's prep in phase C)
CASES = {
    "cdf": (dict(hist_mode="cdf"), 1, None),
    "chol": (dict(hist_mode="chol"), 1, None),
    "chol_chunked": (dict(hist_mode="chol", batch=2, batch_chunk=1), 2, None),
    "cdf_low_mem": (dict(hist_mode="cdf"), 1, 0),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def style():
    return imageio.load_image(SAMPLE, 64)


def _synth(kw, budget, monkeypatch):
    monkeypatch.setattr(tcore.Synthesizer, "_PREP_PREFETCH_BYTES", budget)
    base = dict(size=64, passes=2, iters=40, no_multires=True, depth=DEPTH,
                seed=3, style=["graffiti.png"])
    base.update(kw)
    return tcore.Synthesizer(tconfig.OptexConfig(**base), device="cpu")


def _noise(batch):
    return np.random.default_rng(5).uniform(
        size=(batch, 64, 64, 3)).astype(np.float32)


def _optex(events):
    return [e for e in events if e.name.startswith("optex.")]


def _inside(e, outer):
    return (outer.time_range.start <= e.time_range.start
            and e.time_range.end <= outer.time_range.end)


def _nearest_span(e):
    p = e.cpu_parent
    while p is not None and not p.name.startswith("optex."):
        p = p.cpu_parent
    return p


def _is_leaf(span):
    """No ``optex`` child but fetches."""
    return not any(c.name.startswith("optex.") and c.name != "optex.fetch"
                   for c in span.cpu_children)


@pytest.fixture(scope="module")
def runs(style):
    """Each case's run with the profiler on (its events and output) and
    off (its output)."""
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for case, (kw, batch, budget) in CASES.items():
            synth = _synth(kw, budget, mp)
            plain = synth.run(_noise(batch), [style], key=11)
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                traced = synth.run(_noise(batch), [style], key=11)
            out[case] = (synth, list(prof.events()), plain, traced)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_run_records_one_run_a_pass_each_and_depth_stages(runs, case):
    synth, events, _, _ = runs[case]
    low_mem = CASES[case][2] == 0
    spans = _optex(events)
    names = [e.name for e in spans]
    assert names.count("optex.run") == 1
    run = next(e for e in spans if e.name == "optex.run")
    passes = [e for e in spans if e.name == "optex.pass"]
    assert len(passes) == len(synth.iters_table) == 2
    for p in passes:
        assert _inside(p, run)
        stages = [e for e in spans if e.name == "optex.stage"
                  and _inside(e, p)]
        assert len(stages) == DEPTH
    assert names.count("optex.stage") == 2 * DEPTH
    assert names.count("optex.style_prep") == 1
    assert names.count("optex.style_encode") == 1   # one prep: no multires
    # the eigenvalues: at once, or a depth at a time in the low-memory prep
    assert names.count("optex.fetch") == (DEPTH if low_mem else 1)


@pytest.mark.parametrize("case", list(CASES))
def test_every_stage_holds_its_leaves_in_order(runs, case):
    _, events, _, _ = runs[case]
    spans = _optex(events)
    for stage in (e for e in spans if e.name == "optex.stage"):
        kids = sorted((c for c in stage.cpu_children
                       if c.name.startswith("optex.")),
                      key=lambda c: c.time_range.start)
        # chunked: encode/project a chunk each, then the map, then each
        # chunk's apply/unproject/decode; the first of each name in order
        firsts = []
        for c in kids:
            if c.name not in firsts:
                firsts.append(c.name)
        assert firsts == list(STAGE_LEAVES)   # every stage takes steps
        for c in kids:
            assert _inside(c, stage) and _is_leaf(c)


@pytest.mark.parametrize("case", list(CASES))
def test_every_op_inside_the_run_lies_in_a_leaf(runs, case):
    _, events, _, _ = runs[case]
    run = next(e for e in events if e.name == "optex.run")
    ops = [e for e in events if e.name.startswith("aten::")
           and _inside(e, run)]
    assert ops
    for op in ops:
        span = _nearest_span(op)
        assert span is not None and span.name != "optex.run", op.name
        assert _is_leaf(span), (op.name, span.name)


@pytest.mark.parametrize("case", list(CASES))
def test_output_is_bit_equal_with_the_profiler_on(runs, case):
    _, _, plain, traced = runs[case]
    assert torch.equal(plain, traced)


def test_run_args_carry_the_run_key(style, monkeypatch):
    seen = []
    real = torch.profiler.record_function

    def recording(name, args=None):
        seen.append((name, args))
        return real(name, args)

    monkeypatch.setattr(torch.profiler, "record_function", recording)
    synth = _synth(dict(hist_mode="chol", iters=2), None, monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]):
        synth.run(_noise(1), [style], key=424242)
    run_args = [a for n, a in seen if n == "optex.run"]
    assert len(run_args) == 1
    assert "key=424242" in run_args[0] and "hist_mode=chol" in run_args[0]
    stage_args = [a for n, a in seen if n == "optex.stage"]
    assert stage_args[0].startswith(f"depth={DEPTH} C=128 k=")
    assert all(a is None for n, a in seen if n == "optex.encode")


def test_span_without_a_profiler_is_the_shared_no_op():
    def args():
        raise AssertionError("args made without a profiler")

    a, b = trace.span("optex.run", args), trace.span("optex.pass")
    assert a is b
    with a:
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("optex.pass", lambda: "p=0"):
            got = trace.fetch(torch.arange(3))
    assert got.tolist() == [0, 1, 2]
    names = [e.name for e in prof.events()]
    assert names.count("optex.pass") == names.count("optex.fetch") == 1
