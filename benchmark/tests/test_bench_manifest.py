"""BENCHMARK.json against the contract, and the imports of every module
under benchmark/."""

import ast
import os

import pytest

from benchlib import cells, manifest

BENCH = cells.BENCH
ROOT = cells.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "optimaltextures_tpu"}


def test_manifest_meets_the_contract():
    assert manifest.problems(cells.manifest(), ROOT) == []


@pytest.mark.parametrize("change, word", [
    (lambda m: m["end_to_end"][0].update(bound=0.3), "bound"),
    (lambda m: m["workloads"][0].update(chips=2), "chips"),
    (lambda m: m["per_layer"][0].update(moves="nope"), "moves"),
    (lambda m: m["configs"][0].update(reduced=["hidden_size"]), "reduced"),
    (lambda m: m.update(run_seconds=60), "run_seconds"),
    (lambda m: m["per_layer"][0].update(unit="tokens per s"), "unit"),
])
def test_manifest_faults_are_found(change, word):
    import copy

    m = copy.deepcopy(cells.manifest())
    change(m)
    assert any(word in p for p in manifest.problems(m, ROOT))


def test_every_cell_loads_with_its_files():
    for w in cells.manifest()["workloads"]:
        c = cells.load(w["name"])
        assert {"pass_rel_rms", "link_rel_rms", "u8_rel_rms"} <= \
            set(c.limits) <= {"pass_rel_rms", "link_rel_rms", "u8_rel_rms",
                              "ot_rel_rms"}
        assert c.per_layer and any(m["name"] == "setup_s"
                                   for m in c.end_to_end)
        assert c.traffic["batch"] >= 1 and c.config["num_layers"] == 3


def _modules():
    for d, _, fs in os.walk(BENCH):
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_module_imports_jax_or_the_jax_package(path):
    """Top-level names compared whole: the port's name begins with the JAX
    package's."""
    assert not _imports(path) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_port():
    seen, todo = set(), ["reference"]
    while todo:
        mod = todo.pop()
        seen.add(mod)
        path = os.path.join(BENCH, "benchlib", mod + ".py")
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    names = [a.name for a in node.names] if not node.module \
                        else [node.module]
                    todo += [n for n in names if n not in seen and
                             os.path.exists(os.path.join(BENCH, "benchlib",
                                                         n + ".py"))]
                    continue
                names = [node.module]
            tops = {n.split(".")[0] for n in names}
            assert not tops & (FORBIDDEN | {"optimaltextures_tpu_torch"}), \
                (mod, tops)
