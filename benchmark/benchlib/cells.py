"""Cells by name: the workload's entry in ``BENCHMARK.json``, its
configuration file, its traffic file (``benchmark/traffic/<traffic>.json``),
its limits (``benchmark/limits/<workload>.json``) and the metrics it
reports. Nothing here names a cell: a cell is added by adding files and
entries."""

from __future__ import annotations

import json
import os
from typing import NamedTuple

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list       # metric entries this cell reports with --trace 0
    per_layer: list        # ... with --trace 1


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def reports(metric: dict, cell: str, e2e_names) -> bool:
    """Whether ``cell`` reports ``metric``: listed in its ``workloads``, or,
    without that key, a per-layer metric whose end-to-end metric the cell
    reports (an end-to-end one: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load(name: str, root: str = ROOT) -> Cell:
    m = manifest(root)
    wl = {w["name"]: w for w in m["workloads"]}.get(name)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg = {c["name"]: c for c in m["configs"]}[wl["config"]]
    e2e = [x for x in m["end_to_end"] if reports(x, name, ())]
    names = {x["name"] for x in e2e}
    per_layer = [x for x in m["per_layer"] if reports(x, name, names)]
    return Cell(name, int(wl["chips"]), load_json(os.path.join(root,
                                                               cfg["file"])),
                load_json(os.path.join(BENCH, "traffic",
                                       wl["traffic"] + ".json")),
                load_json(os.path.join(BENCH, "limits", name + ".json")),
                e2e, per_layer)


def program_kwargs(cell: Cell) -> dict:
    """The ``OptexConfig`` fields of the cell: the configuration's, with
    the traffic's size, batch, mode and cards."""
    c, t = cell.config, cell.traffic
    return dict(size=t["size"], passes=c["passes"], iters=c["iters"],
                hist_mode=t["hist_mode"], batch=t["batch"],
                depth=c["num_layers"], conv_dtype=c["conv_dtype"],
                no_pca=not c["pca"], compat_schedule_quirk=c["schedule_quirk"],
                spatial_devices=t.get("spatial_devices", 1))
