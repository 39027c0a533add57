"""The benchmark's entry: argument parsing, the card checks, one run of a
cell (in this process, or on one process a card), and the result line."""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import importlib.util

from . import cells, profiling, readers, session


def card_info() -> dict:
    """Each card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return {"error": str(e)}
    return {"cards": [line.strip() for line in out]}


def load_reader(name: str):
    path = os.path.join(cells.BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def e2e_value(name: str, r: dict):
    if name == "setup_s":
        return r["setup_s"]
    if name == "images_per_s":
        return r["images"] / r["window_s"]
    if name == "sec_per_image":
        return r["window_s"] / r["images"]
    raise KeyError(f"no end-to-end metric {name!r}")


def one_run(cell, name: str, seed: int, seconds: float, trace: bool,
            wall0: float, controls: bool = False) -> dict:
    """session.run in this process, or on one process a card (NCCL) with
    the kernels built here first."""
    if cell.chips == 1:
        return session.run(None, cell, seed, seconds, trace, wall0,
                           controls=controls)
    from optimaltextures_tpu_torch.ops import cuda_build
    from optimaltextures_tpu_torch.parallel import mesh

    cuda_build.set_build_dir(os.path.join(cells.ROOT, session.BUILD_DIR))
    cuda_build.build("codec", "cdf", "conv_wg", "edge_mma")
    return mesh.spawn(session.rank_main, cell.chips, backend="nccl",
                      args=(name, seed, seconds, trace, wall0, controls),
                      deadline_s=330.0)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, wall0: float) -> int:
    args = parse(argv)
    cell = cells.load(args.workload)
    import torch

    import optimaltextures_tpu_torch  # noqa: F401  (the system under test)

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    card = card_info()
    print(f"cards: {card}", file=sys.stderr, flush=True)
    trace = bool(args.trace)
    r = one_run(cell, args.workload, args.seed, args.seconds, trace, wall0)
    session.check_modules()

    metrics = {}
    if trace:
        ctx = readers.Ctx(cell, r)
        for m in cell.per_layer:
            v = load_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(e2e_value(m["name"], r)),
                                  "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": int(r["memory_peak"])}
    line = {"correct": False, "attempted": r["images"], "failed": 0,
            "metrics": metrics, "device": device}
    t = r.get("trace")
    if trace and t is not None:
        device["busy_s"] = profiling.busy_us(t) / 1e6
        device["window_s"] = t.window_us / 1e6
        line["breakdown"] = profiling.breakdown(t)
    nums, lim = r["numbers"], cell.limits
    line["correct"] = all(nums.get(k, math.inf) <= v for k, v in lim.items())
    line["card"] = card
    line["run"] = {"calls": r["calls"], "window_s": r["window_s"],
                   "call_s_quartiles": r["call_s"],
                   "setup_s": r["setup_s"], "check_s": r["check_s"],
                   "check_call": r["check_call"], "pass_rels": r["pass_rels"],
                   **({"launches": r["launches"]} if trace else {})}
    line["checks"] = {k: {"value": nums.get(k), "limit": v}
                      for k, v in lim.items()}
    print(json.dumps(line), flush=True)
    for k, v in lim.items():
        print(f"check {k}: {nums.get(k)!r} (limit {v!r})", file=sys.stderr)
    return 0
