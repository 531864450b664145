"""The benchmark's data and code, found by name: ``BENCHMARK.json`` at the
root of the checkout, and under ``perfbench/`` one file a configuration
(``configs/<config>.json``, the file BENCHMARK.json names), a traffic mix
(``traffic/<traffic>.json``), a cell's check (``workloads/<cell>.json``), a
per-layer metric's reader (``metrics/<metric>.py``), a kind of traffic
(``kinds/<kind>.py``, named by a mix's ``kind``) and an algorithm's
adapter and reference update (``algs/<alg>.py``, named by a
configuration's ``alg``)."""
from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
_LOADED = {}


def _json(path):
    with open(path) as fh:
        return json.load(fh)


def benchmark(root=ROOT):
    return _json(os.path.join(root, "BENCHMARK.json"))


def cell(name, bench=None, root=ROOT):
    """Everything one cell runs on: {"name", "root", "chips", "config",
    "traffic", "check", "end_to_end", "per_layer"}; the metric lists are
    BENCHMARK.json's entries that this cell reports."""
    bench = bench or benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    here = os.path.join(root, "perfbench")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return {"name": name, "root": root, "chips": entry["chips"],
            "config": _json(os.path.join(root, conf["file"])),
            "traffic": _json(os.path.join(here, "traffic", entry["traffic"] + ".json")),
            "check": _json(os.path.join(here, "workloads", name + ".json")),
            "end_to_end": e2e, "per_layer": per_layer}


def _module(folder, name, root):
    """The module in ``perfbench/<folder>/<name>.py``, loaded once a path."""
    path = os.path.join(root, "perfbench", folder, name + ".py")
    if path not in _LOADED:
        mod_name = f"perfbench_{folder}_" + name.replace(".", "_").replace("-", "_")
        mod_spec = importlib.util.spec_from_file_location(mod_name, path)
        module = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(module)
        _LOADED[path] = module
    return _LOADED[path]


def reader(metric, root=ROOT):
    """The ``read(rec)`` function of a per-layer metric."""
    return _module("metrics", metric, root).read


def kind(name, root=ROOT):
    """The module of a traffic kind; its ``Runner(cell, seed, device)``
    drives the program (perfbench/traffic.py names what a runner does)."""
    return _module("kinds", name, root)


def alg(name, root=ROOT):
    """The module of an algorithm: its networks' leaves, how the program
    holds them, and its reference update (perfbench/algs/mappo.py)."""
    return _module("algs", name, root)
