"""The codec kernels' ptxas summaries in two trees, side by side: every
reflect instantiation's registers, stack, spills, shared memory and
barriers in this tree against the same kernel in another checkout (a
parent unpacked with ``git archive``), and every wrap instantiation's own.

    python3 optimaltextures_tpu_torch/tools/ptxas_diff.py --root TREE
        [--sources codec conv_wg edge_mma]

Each ``csrc/<source>.cu`` of both trees compiles with ``nvcc -Xptxas -v``
and this tree's flags (``ops/cuda_build.NVCC_FLAGS``), one process per
file, all started together. Kernels are matched by their demangled names
(``c++filt``, else ``cu++filt``), without the parameter list, after this
tree's last template argument ``false`` (the WRAP of a reflect
instantiation) is dropped, unless the other tree has the instantiation
itself (a parent with the WRAP parameter: then the wrap instantiations are
compared too). Prints one line per kernel and any ptxas "Performance
Loss" remark (a serialized ``wgmma``: C7518, C7514); exits 1 if a compared
instantiation differs from its counterpart, a reflect one is missing
there, or a wrap instantiation of ``csrc/conv_wg.cu`` or
``csrc/edge_mma.cu`` spills.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
import tempfile

_HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCES = ("codec", "conv_wg", "edge_mma")
NO_SPILL = ("conv_wg", "edge_mma")


def _compile_all(jobs):
    """{(tree, source): ptxas output} for jobs [(tree, source, .cu path)],
    one nvcc each, all started together."""
    sys.path.insert(0, _HERE)
    from optimaltextures_tpu_torch.ops import cuda_build

    out_dir = tempfile.mkdtemp(prefix="ptxas_diff_")
    procs = {}
    for tree, source, cu in jobs:
        lib = os.path.join(out_dir, f"lib{source}_{tree}.so")
        procs[(tree, source)] = subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    logs = {}
    for key, proc in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {key}:\n{err}{out}")
        logs[key] = err + out
    shutil.rmtree(out_dir, ignore_errors=True)
    return logs


def parse(log: str) -> dict:
    """{mangled kernel: {"regs", "stack", "spill_st", "spill_ld", "smem",
    "barriers"}} from ``-Xptxas -v`` output, and the remarks under "remarks"."""
    kernels, cur = {}, None
    remarks = [l.strip() for l in log.splitlines() if "Performance" in l]
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = kernels.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_st=int(m.group(2)),
                       spill_ld=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["regs"] = int(m.group(1))
            b = re.search(r"used (\d+) barriers", line)
            s = re.search(r"(\d+) bytes smem", line)
            cur["barriers"] = int(b.group(1)) if b else 0
            cur["smem"] = int(s.group(1)) if s else 0
    return {"kernels": kernels, "remarks": remarks}


def _demangle(names):
    """{mangled: demangled} in c++filt's form (cu++filt's `<unnamed>` and
    `(int)64`, `(bool)1` rewritten to it)."""
    for tool in ("c++filt", os.path.join(os.path.dirname(_nvcc()), "cu++filt")):
        path = tool if os.path.exists(tool) else shutil.which(tool)
        if path:
            out = subprocess.run([path], input="\n".join(names), capture_output=True,
                                 text=True, check=True).stdout.splitlines()
            out = [re.sub(r"\((?:unsigned )?(?:int|long)\)", "",
                          d.replace("<unnamed>", "(anonymous namespace)")
                          .replace("(bool)1", "true").replace("(bool)0", "false"))
                   for d in out]
            return dict(zip(names, out))
    raise RuntimeError("no c++filt or cu++filt to demangle the kernel names")


def _nvcc():
    sys.path.insert(0, _HERE)
    from optimaltextures_tpu_torch.ops import cuda_build

    return cuda_build.nvcc_path()


def base(demangled: str) -> str:
    """A demangled kernel's name without its namespace and parameters."""
    d = demangled.replace("(anonymous namespace)::", "")
    d = re.sub(r"^void ", "", d)
    return re.sub(r"^\w*_GLOBAL__N_\w*::", "", d).split("(")[0].strip()


def key(demangled: str):
    """This tree's kernel: (its name without parameters and without the
    last template argument, WRAP; wrap?)."""
    d = base(demangled)
    for tail, wrap in ((", false>", False), (", true>", True)):
        if d.endswith(tail):
            return d[:-len(tail)] + ">", wrap
    for tail, wrap in (("<false>", False), ("<true>", True)):
        if d.endswith(tail):
            return d[:-len(tail)], wrap
    return d, False


def _fmt(k: dict) -> str:
    return (f"{k.get('regs')} registers, {k.get('stack')} B stack, {k.get('spill_st')}/"
            f"{k.get('spill_ld')} B spill stores/loads, {k.get('smem')} B static smem, "
            f"{k.get('barriers')} barriers")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="the other checkout (the parent)")
    ap.add_argument("--sources", nargs="+", default=list(SOURCES), choices=SOURCES)
    args = ap.parse_args()
    other = os.path.join(os.path.abspath(args.root), "optimaltextures_tpu_torch", "csrc")
    mine = os.path.join(_HERE, "optimaltextures_tpu_torch", "csrc")
    jobs = [(t, s, os.path.join(d, s + ".cu")) for s in args.sources
            for t, d in (("parent", other), ("this", mine))]
    logs = _compile_all(jobs)
    bad = 0
    for source in args.sources:
        old, new = parse(logs[("parent", source)]), parse(logs[("this", source)])
        names = _demangle(list(old["kernels"]) + list(new["kernels"]))
        old_by = {base(names[m]): v for m, v in old["kernels"].items()}
        for m, v in sorted(new["kernels"].items(), key=lambda kv: names[kv[0]]):
            name, wrap = key(names[m])
            # a parent with the WRAP parameter has this very instantiation;
            # one from before it has the reflect kernel without it
            was = old_by.get(base(names[m]))
            if was is None and not wrap:
                was = old_by.get(name)
            flag = ""
            if wrap:
                spills = v.get("spill_st", 0) + v.get("spill_ld", 0)
                if source in NO_SPILL and spills:
                    flag, bad = "  SPILLS", bad + 1
            if wrap and was is None:
                print(f"ptxas {source} {name} [wrap]: {_fmt(v)}{flag}", flush=True)
                continue
            same = was == v
            bad += not same
            print(f"ptxas {source} {name} [{'wrap' if wrap else 'reflect'}]: "
                  f"{_fmt(v)}; parent: {_fmt(was) if was else 'missing'} -> "
                  f"{'equal' if same else 'DIFFERS'}{flag}", flush=True)
        for tree, p in (("parent", old), ("this", new)):
            for r in p["remarks"]:
                print(f"ptxas {source} remark ({tree}): {r}", flush=True)
    print(f"ptxas_diff: {bad} difference(s)", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
