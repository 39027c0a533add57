"""The span readers (``benchlib/spans.py``) on a synthetic trace: the device
time each ``optex`` span launched, the fetches a call, the pairing's
refusals, the parent program without spans, the earlier readers unmoved by
spans among the host ops, and the manifest's five span metrics."""

import pytest

from benchlib import cells, manifest, profiling, readers, schedule, spans
from benchlib.cell import load_reader

CELL = "bf16-b128-cdf"
SPAN_METRICS = ("ot_steps_ms.batch", "rot_draw_ms.batch",
                "style_prep_ms.batch", "codec_ms.batch", "host_fetches.batch")
EARLIER = ("ot_gemm_ms.batch", "cdf_roofline", "codec_roofline.bf16",
           "device_idle.batch", "peak_gib.batch", "mfu.batch")

# (host start of the launch call, its name, the innermost op or span it
# lies in, the device op's name and microseconds); the device runs them in
# launch order, 2000 us after the host queued them
LAUNCHES = [
    (15, "cudaLaunchKernel", "aten::convolution", "conv_kernel", 40.0),
    (30, "cudaLaunchKernelExC", "optex.style_encode", "rgb_to_relu1_mma", 8.0),
    (62, "cudaMemcpyAsync", "aten::copy_", "Memcpy DtoH (Device -> Pageable)",
     3.0),
    (120, "cudaLaunchKernel", "optex.encode", "conv3x3_wg<64>", 50.0),
    (206, "cudaLaunchKernel", "aten::mm", "sm80_xmma_gemm_f32f32", 20.0),
    (311, "cudaLaunchKernel", "aten::mm", "sm80_xmma_gemm_f32f32", 100.0),
    (400, "cudaLaunchKernelExC", "optex.ot_steps", "histogram_cluster", 30.0),
    (500, "cudaMemsetAsync", "aten::zero_", "Memset (Device)", 1.0),
    (610, "cudaLaunchKernel", "optex.ot_steps", "pwl_tables", 25.0),
    (710, "cudaLaunchKernel", "optex.decode", "upconv_wg<64>", 60.0),
    (810, "cudaLaunchKernel", "aten::to", "cast_kernel", 4.0),
    (906, "cudaMemcpyAsync", "aten::copy_", "Memcpy DtoH (Device -> Pageable)",
     9.0),
]
# the program's spans and ops of one call, and the harness's copy after it
HOST = [
    (profiling.WINDOW, 0, 1000),
    ("optex.run", 10, 900),
    ("optex.style_prep", 10, 100),
    ("optex.style_encode", 12, 50), ("aten::convolution", 14, 20),
    ("optex.targets", 55, 95), ("optex.fetch", 60, 90),
    ("aten::copy_", 61, 89),
    ("optex.pass", 100, 800), ("optex.stage", 110, 790),
    ("optex.encode", 110, 200),
    ("optex.rotations", 200, 300), ("aten::mm", 205, 215),
    ("optex.ot_steps", 300, 700), ("aten::mm", 310, 320),
    ("aten::zero_", 499, 510),
    ("optex.decode", 700, 790),
    ("optex.quantize", 800, 850), ("aten::to", 805, 815),
    ("aten::copy_", 905, 990),
]
CALLS = 2
BATCH = 128


def _trace(launches=LAUNCHES, host=HOST, ops=None):
    h = list(host) + [(name, t, t + 1) for t, name, _, _, _ in launches]
    dev, t0 = [], 2000.0
    for _, _, _, name, us in launches:
        dev.append((name, t0, t0 + us))
        t0 += us + 5.0
    if ops is None:   # the profiler's linked self device time by op name
        ops = {}
        for _, _, op, _, us in launches:
            ops[op] = ops.get(op, 0.0) + us
        ops = [(n, us, 1) for n, us in ops.items()]
    return profiling.Trace(dev, h, ops, 1000.0 + t0, 0.0)


def _ctx(trace):
    cell = cells.load(CELL)
    plan = schedule.pass_plan(512, 500, 5, 3, (512, 512))
    ks = [[174, 74, 24]] * 5
    result = {"trace": trace, "traced_calls": list(range(CALLS)),
              "plan": plan, "style_hw": (512, 512),
              "traced_ks": [ks] * CALLS, "window_ks": [ks] * 15,
              "window_s": 30.0, "window_peak": 17 * 2 ** 30}
    return readers.Ctx(cell, result)


def _us(*names):
    return sum(us for _, _, op, _, us in LAUNCHES if op in names)


def test_each_span_holds_the_device_time_it_launched():
    got = {n: d for n, _, _, d in spans.span_device_us(_trace())}
    assert got["optex.style_encode"] == 48.0
    assert got["optex.fetch"] == 3.0
    assert got["optex.style_prep"] == 51.0
    assert got["optex.ot_steps"] == 156.0
    assert got["optex.stage"] == 50 + 20 + 156 + 60
    # all but the harness's copy of the result
    assert got["optex.run"] == sum(x[4] for x in LAUNCHES) - 9.0


@pytest.mark.parametrize("metric, want", [
    ("ot_steps_ms.batch", 156.0 / 1e3 / (CALLS * BATCH)),
    ("rot_draw_ms.batch", 20.0 / 1e3 / (CALLS * BATCH)),
    ("style_prep_ms.batch", 51.0 / 1e3 / (CALLS * BATCH)),
    ("codec_ms.batch", 110.0 / 1e3 / (CALLS * BATCH)),
    ("host_fetches.batch", 1 / CALLS),
])
def test_span_readers(metric, want):
    assert load_reader(metric)(_ctx(_trace())) == pytest.approx(want)


def test_a_lost_device_op_or_a_shifted_pairing_reads_nothing():
    lost = _trace()._replace(device=_trace().device[:-1])
    assert spans.span_device_us(lost) is None
    # the profiler's own linked figure for aten::mm disagrees by 20 us
    ops = [(n, us + (20.0 if n == "aten::mm" else 0.0), c)
           for n, us, c in _trace().ops]
    assert spans.span_device_us(_trace(ops=ops)) is None
    for m in SPAN_METRICS[:4]:
        assert load_reader(m)(_ctx(lost)) is None


def test_a_program_without_spans_reads_nothing():
    plain = [h for h in HOST if not h[0].startswith("optex.")]
    ctx = _ctx(_trace(host=plain))
    for m in SPAN_METRICS:
        assert load_reader(m)(ctx) is None
    assert load_reader("host_fetches.batch")(_ctx(None)) is None


def test_earlier_readers_are_unmoved_by_spans():
    plain = [h for h in HOST if not h[0].startswith("optex.")]
    with_spans, without = _ctx(_trace()), _ctx(_trace(host=plain))
    for m in EARLIER:
        a, b = load_reader(m)(with_spans), load_reader(m)(without)
        assert a == b and a is not None, m


def test_the_manifest_lists_the_span_metrics():
    m = cells.manifest()
    assert manifest.problems(m, cells.ROOT) == []
    got = {x["name"]: x for x in m["per_layer"]}
    for name in SPAN_METRICS:
        x = got[name]
        assert (x["source"], x["moves"], x["better"], x["workloads"]) == (
            "program_span", "images_per_s", "lower", [CELL])
    assert [x["name"] for x in m["per_layer"]][-5:] == list(SPAN_METRICS)
