"""Readings for the limits of ``correct``: the program and its control
(the reference one precision below the configuration's, put in the
program's place) on several seeds, one line of JSON a seed.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 \
        [--control-seeds 3]

Each seed is a run of the cell with no measured window: the warm call,
then the calls up to the one the comparison samples, then the comparison
in the configured precision and, on the first ``--control-seeds`` seeds
(all by default), in each control's. Each line also says whether each
reading passes the cell's limits (``compare.judge``). The benchmark's own
runs never read the control."""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

if __name__ == "__main__":
    import argparse

    from benchlib import cell, cells, compare

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=None)
    args = ap.parse_args()
    c = cells.load(args.workload)
    n_ctl = len(args.seeds) if args.control_seeds is None \
        else args.control_seeds
    for i, seed in enumerate(args.seeds):
        t0 = time.time()
        r = cell.one_run(c, args.workload, seed, 0.0, False, t0,
                         controls=i < n_ctl)
        passes = {k: compare.judge(v, {a: b for a, b in c.limits.items()
                                       if a in v})
                  for k, v in r["readings"].items()}
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "readings": r["readings"], "passes": passes,
                          "check_s": r["check_s"],
                          "s": time.time() - t0}), flush=True)
