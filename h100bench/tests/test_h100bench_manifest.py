"""BENCHMARK.json and the harness's files: the allowed characters, every
file found by its name, each per-layer metric's cells reporting the metric
it moves, the harness free of the JAX package, the reference free of the
port, and run.py refusing to run without a card."""

import ast
import json
import os
import re
import subprocess
import sys

from conftest import BENCH, ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    B = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
JAX_NAMES = {"jax", "jaxlib", "flax", "rovr_tpu", "__graft_entry__"}


def _names():
    yield from (c["name"] for c in B["configs"])
    for c in B["configs"]:
        yield from c["reduced"]
    for w in B["workloads"]:
        yield from (w["name"], w["config"], w["traffic"])
    yield from (m["name"] for m in B["end_to_end"] + B["per_layer"])


def test_names_and_units_use_the_allowed_characters():
    for n in _names():
        assert NAME.match(n), n
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in B[group]]
        assert len(names) == len(set(names)), group
    for entry in B["configs"] + B["workloads"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"], entry["name"]
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}, c["name"]


def test_each_cells_files_are_found_by_name():
    for w in B["workloads"]:
        conf = next(c for c in B["configs"] if c["name"] == w["config"])
        assert os.path.isfile(os.path.join(ROOT, conf["file"]))
        assert conf["file"].startswith("h100bench/configs/")
        assert os.path.isfile(os.path.join(BENCH, "traffic", f"{w['traffic']}.json"))
        assert os.path.isfile(os.path.join(BENCH, "cells", f"{w['name']}.json"))
    for m in B["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH, "metrics", f"{m['name']}.py")), m["name"]


def test_each_config_file_is_its_preset_with_its_overrides():
    import dataclasses

    from rovr_torch import config as C

    presets = {"Config()": C.Config(),
               "config_rl_scaled(vid_length=64, data_parallel=1)": C.config_rl_scaled(64, 1)}
    for conf in B["configs"]:
        with open(os.path.join(ROOT, conf["file"])) as f:
            d = json.load(f)
        c = presets[d["preset"]]
        for key, v in d["overrides"].items():
            group, field = key.split(".")
            c = c.replace(**{group: dataclasses.replace(getattr(c, group), **{field: v})})
        assert json.loads(json.dumps(dataclasses.asdict(c))) == d["config"], conf["name"]
        assert d["reduced"] == conf["reduced"] == []


def test_each_per_layer_metrics_cells_report_what_it_moves():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    cells = {w["name"] for w in B["workloads"]}
    for m in B["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert "workloads" not in moved or cell in moved["workloads"], (m["name"], cell)
    for w in B["workloads"]:
        assert any(w["name"] in m.get("workloads", cells) for m in B["per_layer"])
        assert any(m["name"] != "setup_s" and w["name"] in m.get("workloads", cells)
                   for m in B["end_to_end"])


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _relative_levels(path):
    tree = ast.parse(open(path).read())
    return [n.level for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level]


def _sources(top):
    for d, _, files in os.walk(top):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_module_imports_the_jax_package():
    for path in _sources(BENCH):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & JAX_NAMES, (path, tops & JAX_NAMES)


def test_the_reference_imports_nothing_of_the_port():
    """Every file under reference/ is a module that imports torch, the
    standard names below and its siblings there, and nothing else; the
    reference a configuration file names is one of them."""
    top = os.path.join(BENCH, "reference")
    modules = set()
    for d, dirs, files in os.walk(top):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            path = os.path.join(d, f)
            rel = os.path.relpath(path, top)
            assert f.endswith(".py"), path
            modules.add(rel[:-3].replace(os.sep, "."))
            tops = {name.split(".")[0] for name in _imports(path)}
            assert tops <= {"__future__", "math", "typing", "torch"}, (path, tops)
            # a relative import climbs no higher than reference/ itself
            assert all(lvl <= rel.count(os.sep) + 1 for lvl in _relative_levels(path)), path
    for conf in B["configs"]:
        with open(os.path.join(ROOT, conf["file"])) as f:
            named = json.load(f).get("reference", "episode")
        assert named in modules, (conf["name"], named)


def test_run_exits_nonzero_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "h100bench/run.py", "--workload", "default_canvas.serve",
                        "--seed", "3", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
