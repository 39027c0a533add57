"""One run of a cell in one process (or in each rank of a multi-card
cell): set-up, the measured window, the traced calls, the comparison.

Set-up builds one ``core.Synthesizer`` and runs one warm call at the
cell's own shapes. The window then calls ``Synthesizer.run(noise,
[exemplar], key=..., quantize_uint8=True)`` back to back, each call ending
when its uint8 result is on the host, for ``seconds`` seconds (and at
least until the call the comparison samples has run). With ``trace`` a few
more calls run under the profiler after the window. The comparison runs
last, once the program is freed."""

from __future__ import annotations

import gc
import os
import sys
import time

import numpy as np

from . import cells, compare, exemplar, profiling, reference, schedule

BUILD_DIR = "build/torch_kernels"


def _modules_found():
    """The top-level names of JAX and the JAX package in sys.modules,
    compared whole (``optimaltextures_tpu_torch`` is not
    ``optimaltextures_tpu``)."""
    bad = {"jax", "jaxlib", "flax", "optimaltextures_tpu"}
    return sorted({m.split(".")[0] for m in list(sys.modules)} & bad)


def check_modules() -> None:
    found = _modules_found()
    if found:
        raise RuntimeError(f"loaded in the benchmark's process: {found}")


def held_bytes(passes, stage, device) -> int:
    """The bytes on ``device`` of the tensors of the recorded passes and OT
    stage, each storage once (a pass's input is the previous pass's
    output)."""
    seen = {}
    x, y = stage or (None, None)
    for a, vs, b in passes + [(x, [], y)]:
        for t in (a, b, *vs):
            if t is not None and t.device == device:
                st = t.untyped_storage()
                seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def widths(banks, conv_dtype: str, depth: int, style, plan):
    """The PCA widths ks[p][l] the benchmark works out itself from the
    exemplar: the reference's style prep, in the configuration's
    precision."""
    prec = reference.PRECISIONS[conv_dtype]
    ks, seen = [], {}
    for (s, rs, _) in plan:
        key = s if rs else None
        if key not in seen:
            st = (reference.resize(style, schedule.get_size(
                s, style.shape[1], style.shape[2])) if rs else style)
            seen[key] = reference.pass_widths(reference.style_prep(
                banks[prec.conv_dtype], depth, st, prec))
        ks.append(seen[key])
    return ks


def run(mesh, cell: cells.Cell, seed: int, seconds: float, trace: bool,
        wall0: float, device=None, controls: bool = False) -> dict:
    """One run; ``device`` None is the mesh's device or cuda:0 (the CPU
    only for the harness's own tests). ``controls`` also reads the control
    (the reference one precision lower, in the program's place) into
    ``result["readings"]``: the benchmark's own runs do not."""
    import torch

    from optimaltextures_tpu_torch import core
    from optimaltextures_tpu_torch.config import OptexConfig
    from optimaltextures_tpu_torch.ops import cdf, codec, cuda_build

    rank = mesh.rank if mesh is not None else 0
    if device is None:
        device = mesh.device if mesh is not None else torch.device("cuda:0")
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.set_device(device)
        cuda_build.set_build_dir(os.path.join(cells.ROOT, BUILD_DIR))
        codec.build()
        cdf.build()

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    def peak_bytes():
        return torch.cuda.max_memory_allocated(device) if on_card else 0
    cfg = OptexConfig(**cells.program_kwargs(cell))
    synth = core.Synthesizer(cfg, device=device, mesh=mesh)
    tr = cell.traffic
    batch, size = tr["batch"], tr["size"]

    def inputs(i):
        ex = exemplar.style_exemplar(
            device, tr["exemplar_size"], seed,
            i if tr["exemplar"] == "per_call" else 0)
        nz = exemplar.noise(device, (batch, size, size, 3), seed, i)
        return ex, nz, exemplar.run_key(seed, i)

    def call(i):
        ex, nz, key = inputs(i)
        return synth.run(nz, [ex], key=key, quantize_uint8=True).cpu()

    def agree(flag: bool) -> bool:
        """Rank 0's flag on every rank."""
        return flag if mesh is None else bool(mesh.broadcast_int(int(flag)))

    call(-1)                                # the warm call
    sync()
    setup_end = time.time()
    check = int(np.random.default_rng(
        exemplar.derive(seed, 17)).integers(tr["check_among"]))
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    n, rec, ends, peak_before, rec_bytes = 0, None, [], 0, 0
    t0 = time.perf_counter()
    while True:
        if n == check:
            peak_before = peak_bytes()
            with compare.Recorder(core, tr["hist_mode"]) as r:
                u8 = call(n)
            rec = (r.passes, r.stage, u8)
            # the recorded tensors stay on the card till the window closes:
            # the peak from here on is read without them
            rec_bytes = held_bytes(r.passes, r.stage, device)
            if on_card:
                torch.cuda.reset_peak_memory_stats(device)
        else:
            call(n)
        n += 1
        ends.append(time.perf_counter())
        if agree(ends[-1] - t0 >= seconds and n > check):
            break
    window_s = ends[-1] - t0
    calls_s = np.diff([t0] + ends)
    # the program's peak over the window: before the sampled call, and
    # after it less what the harness keeps of it
    window_peak = max(peak_before, peak_bytes() - rec_bytes)

    result = {"calls": n, "images": n * batch, "window_s": window_s,
              "call_s": [float(q) for q in np.percentile(calls_s,
                                                         [0, 25, 50, 75,
                                                          100])],
              "setup_s": setup_end - wall0, "window_peak": window_peak}
    if trace:
        k = tr["trace_calls"]
        codec.reset_launches()
        cdf.reset_launches()

        def traced():
            for t in range(k):
                call(n + t)
            sync()
        result["trace"] = profiling.profile(traced, active=rank == 0,
                                            agree=agree)
        result["traced_calls"] = list(range(n, n + k))
        result["launches"] = {**{f"codec.{a}": b for a, b in
                                 codec.LAUNCHES.items() if b},
                              **{f"cdf.{a}": b for a, b in
                                 cdf.LAUNCHES.items() if b}}
    result["memory_peak"] = max(window_peak, peak_bytes() - rec_bytes)
    check_modules()

    # the comparison, once the program's state is freed
    passes, stage, u8 = rec
    ins, outs = [a for a, _, _ in passes], [b for _, _, b in passes]
    bases = [[None if v is None else v.detach().float().clone() for v in vs]
             for _, vs, _ in passes]
    if mesh is not None:
        ins = [mesh.all_gather(x, dim=1) for x in ins]
        outs = [mesh.all_gather(x, dim=1) for x in outs]
        if stage is not None:
            stage = tuple(mesh.all_gather(x, dim=1) for x in stage)
    del synth, passes, rec
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if rank != 0:
        return result
    c = cell.config
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    weights = os.path.join(cells.ROOT, c["weights_dir"])
    banks = {v: reference.load_bank(weights, c["num_layers"], v, device)
             for v in dt.values()}
    ex, nz, key = inputs(check)
    t1 = time.perf_counter()
    got = compare.readings(
        banks, ex, nz, key, ins, outs, u8.to(device), size=size,
        iters=c["iters"], passes=c["passes"], depth=c["num_layers"],
        mode=tr["hist_mode"], precisions=(c["conv_dtype"],) + (
            reference.CONTROLS[c["conv_dtype"]] if controls else ()),
        passes_bases=bases, stage=stage)
    result["pass_rels"] = got.pop("passes")
    result["numbers"] = got[c["conv_dtype"]]
    result["readings"] = got
    result["check_s"] = time.perf_counter() - t1
    result["check_call"] = check
    del ins, outs, nz, bases, stage
    if trace:
        plan = schedule.pass_plan(size, c["iters"], c["passes"],
                                  c["num_layers"], (size, size))
        style_hw = (tr["exemplar_size"], tr["exemplar_size"])
        memo = {}

        def ks_of(i):
            j = i if tr["exemplar"] == "per_call" else 0
            if j not in memo:
                memo[j] = widths(banks, c["conv_dtype"], c["num_layers"],
                                 inputs(i)[0], plan)
            return memo[j]
        result["window_ks"] = [ks_of(i) for i in range(n)]
        result["traced_ks"] = [ks_of(i) for i in result["traced_calls"]]
        result["plan"] = plan
        result["style_hw"] = style_hw
    return result


def rank_main(mesh, name: str, seed: int, seconds: float, trace: bool,
              wall0: float, controls: bool = False) -> dict:
    """A rank of a multi-card cell (``parallel.mesh.spawn``'s target): the
    same run on every rank, rank 0's result returned, with the peak of the
    fullest card."""
    import torch

    result = run(mesh, cells.load(name), seed, seconds, trace, wall0,
                 controls=controls)
    peak = torch.tensor([float(result["memory_peak"])], device=mesh.device)
    result["memory_peak"] = int(mesh.all_gather(peak).max().item())
    return result
