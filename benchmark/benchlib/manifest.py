"""Checks of ``BENCHMARK.json`` against the benchmark's contract: its keys,
names, units, bounds, files and budget. ``problems`` lists what is wrong
(nothing, for a sound manifest)."""

from __future__ import annotations

import math
import os
import re
from typing import List

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
# words a reduced key may not hold: widths are never cut
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection",
               "head", "expansion", "experts_per_tok", "width", "channels")


def _line(s) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def run_budget(run_seconds: int, cells: int = 24) -> float:
    """Seconds a full check takes with ``cells`` cells."""
    return ((2 + 14 * cells) * (run_seconds + 60) + cells * 2 * 90 + 1200)


def problems(m: dict, root: str) -> List[str]:
    bad = []
    if set(m) != TOP:
        bad.append(f"top-level keys {sorted(m)}")
    paths = m.get("paths", [])
    if not 1 <= len(paths) <= 16 or not all(
            PATH.match(p) and ".." not in p.split("/") for p in paths):
        bad.append(f"paths {paths}")
    cmd = m.get("command", [])
    if not 1 <= len(cmd) <= 32 or not all(_line(w) for w in cmd) or any(
            w.startswith("/") or ".." in w.split("/") for w in cmd):
        bad.append(f"command {cmd}")
    for w in cmd:
        if os.path.exists(os.path.join(root, w)) and not any(
                w == p or w.startswith(p.rstrip("/") + "/") for p in paths):
            bad.append(f"command names {w} outside paths")
    rs = m.get("run_seconds")
    if not isinstance(rs, int) or not 1 <= rs <= 51 or \
            run_budget(rs) > 43200:
        bad.append(f"run_seconds {rs}")

    def under_paths(f):
        return any(f.startswith(p.rstrip("/") + "/") for p in paths)

    configs = {c.get("name"): c for c in m.get("configs", [])}
    if not 1 <= len(configs) <= 24 or len(configs) != len(m["configs"]):
        bad.append("configs: 1 to 24, distinct names")
    files = set()
    for c in m.get("configs", []):
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            bad.append(f"config keys {sorted(c)}")
        if not NAME.match(c.get("name", "")) or not _line(c.get("source")) \
                or not _line(c.get("why")):
            bad.append(f"config {c.get('name')}: name, source or why")
        f = c.get("file", "")
        if not under_paths(f) or f in files or not os.path.exists(
                os.path.join(root, f)):
            bad.append(f"config {c.get('name')}: file {f}")
        files.add(f)
        red = c.get("reduced", [])
        if len(red) > 16 or not all(NAME.match(k) for k in red) or any(
                k.endswith(("_dim", "_rank")) or any(
                    w in k for w in WIDTH_WORDS) for k in red):
            bad.append(f"config {c.get('name')}: reduced {red}")
    wls = m.get("workloads", [])
    names = [w.get("name") for w in wls]
    if not 1 <= len(wls) <= 24 or len(set(names)) != len(names):
        bad.append("workloads: 1 to 24, distinct names")
    pairs = set()
    for w in wls:
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            bad.append(f"workload keys {sorted(w)}")
        if not all(NAME.match(str(w.get(k, ""))) for k in
                   ("name", "config", "traffic")) or not _line(w.get("why")):
            bad.append(f"workload {w.get('name')}: names or why")
        if w.get("config") not in configs:
            bad.append(f"workload {w.get('name')}: config {w.get('config')}")
        if w.get("chips") not in (1, 4):
            bad.append(f"workload {w.get('name')}: chips {w.get('chips')}")
        pair = (w.get("config"), w.get("traffic"))
        if pair in pairs:
            bad.append(f"workload {w.get('name')}: pair {pair} twice")
        pairs.add(pair)
    four = sum(w.get("chips") == 4 for w in wls)
    if four > max(1, math.floor(0.25 * len(wls))):
        bad.append(f"{four} four-chip cells of {len(wls)}")
    used = {w.get("config") for w in wls}
    if set(configs) - used:
        bad.append(f"configs used by no cell: {sorted(set(configs) - used)}")
    metric_names = []
    e2e = m.get("end_to_end", [])
    if not 1 <= len(e2e) <= 16 or "setup_s" not in [x.get("name")
                                                    for x in e2e]:
        bad.append("end_to_end: 1 to 16 with setup_s")
    for x in e2e:
        if not set(x) <= {"name", "unit", "better", "bound", "source",
                          "workloads"} or not {"name", "unit", "better",
                                               "bound", "source"} <= set(x):
            bad.append(f"end_to_end keys {sorted(x)}")
        b = x.get("bound")
        if not isinstance(b, (int, float)) or not 0.01 <= b <= 0.25:
            bad.append(f"{x.get('name')}: bound {b}")
        if x.get("source") not in ("host_clock", "device_trace"):
            bad.append(f"{x.get('name')}: source {x.get('source')}")
        metric_names.append(x.get("name"))
    pl = m.get("per_layer", [])
    if not 1 <= len(pl) <= 128:
        bad.append("per_layer: 1 to 128")
    for x in pl:
        if not {"name", "unit", "better", "source", "layer", "moves"} <= \
                set(x) or not set(x) <= {"name", "unit", "better", "source",
                                         "layer", "moves", "workloads"}:
            bad.append(f"per_layer keys {sorted(x)}")
        if x.get("moves") not in [y.get("name") for y in e2e]:
            bad.append(f"{x.get('name')}: moves {x.get('moves')}")
        if not _line(x.get("layer")):
            bad.append(f"{x.get('name')}: layer")
        if x.get("source") not in SOURCES:
            bad.append(f"{x.get('name')}: source {x.get('source')}")
        if not os.path.exists(os.path.join(root, paths[0] if paths else "",
                                           "metrics", x.get("name", "")
                                           + ".py")):
            bad.append(f"{x.get('name')}: no reader file")
        metric_names.append(x.get("name"))
    for x in e2e + pl:
        if not NAME.match(str(x.get("name", ""))) or not UNIT.match(
                str(x.get("unit", ""))) or x.get("better") not in (
                    "lower", "higher"):
            bad.append(f"metric {x.get('name')}: name, unit or better")
        for w in x.get("workloads", []):
            if w not in names:
                bad.append(f"{x.get('name')}: workload {w}")
    if len(set(metric_names)) != len(metric_names):
        bad.append("metric names repeat")
    # every cell: setup_s, another end-to-end metric, a per-layer metric;
    # each per-layer metric's cells report what it moves
    for w in names:
        mine = {x["name"] for x in e2e if w in x.get("workloads", [w])}
        if "setup_s" not in mine or len(mine) < 2:
            bad.append(f"{w}: end-to-end metrics {sorted(mine)}")
        layer = [x for x in pl if w in x.get("workloads", [w])
                 and x.get("moves") in mine]
        if not layer:
            bad.append(f"{w}: no per-layer metric")
        for x in pl:
            if w in x.get("workloads", []) and x.get("moves") not in mine:
                bad.append(f"{x['name']} in {w}, which lacks {x['moves']}")
    return bad
