"""BENCHMARK.json and the files it names: the contract's shapes, every cell,
metric, kind of traffic and algorithm found by name, and a cell, a
configuration, a metric, a kind and an algorithm added as files alone."""
import json
import os
import re
import shutil

import pytest

from perfbench import harness, spec, traffic

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in BENCH["end_to_end"] + BENCH["per_layer"])
    assert all(m["better"] in ("lower", "higher") for m in BENCH["end_to_end"] + BENCH["per_layer"])
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert len(json.dumps(BENCH)) < 64 * 1024
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"] and "\t" not in x["why"]
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_loads(entry):
    c = spec.cell(entry["name"])
    assert entry["chips"] == 1
    assert callable(spec.kind(c["traffic"]["kind"]).Runner)
    assert traffic.alg_of(c).leaves
    assert c["config"]["name"] == entry["config"] and c["config"]["reduced"] == []
    reported = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2 and c["per_layer"]
    assert all(m["moves"] in reported for m in c["per_layer"])
    for m in c["per_layer"]:
        assert callable(spec.reader(m["name"]))


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_reader_finds_nothing_in_nothing(metric):
    assert spec.reader(metric["name"])({}) is None


def test_added_by_files_alone(tmp_path):
    """A copy of the benchmark plus one configuration, one traffic mix, one
    cell and one per-layer metric, each a new file and a new entry: found
    by name, with no file of the harness edited."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(spec.ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    conf = json.loads((root / "perfbench/configs/case33_mappo.json").read_text())
    conf["name"] = "case141_mappo"
    conf["grid"] = {"builder": "synthetic_radial", "n_bus": 141, "n_load": 84, "n_sgen": 22,
                    "n_zone": 9, "vn_kv": 12.5, "total_load_mw": 12.19,
                    "pv_penetration": 2.0, "seed": 141}
    (root / "perfbench/configs/case141_mappo.json").write_text(json.dumps(conf))
    (root / "perfbench/traffic/train2048.json").write_text(
        json.dumps({"kind": "train", "lanes": 2048, "overrides": {}, "why": "dummy"}))
    (root / "perfbench/workloads/case141_mappo.train2048.json").write_text(
        json.dumps({"check": {"chunks": 3, "lanes": 32, "pairs": 512}, "limits": {}}))
    (root / "perfbench/metrics/dummy_ms.py").write_text("def read(rec):\n    return rec.get('x')\n")
    bench["configs"].append({"name": "case141_mappo", "source": "https://example.org",
                             "file": "perfbench/configs/case141_mappo.json", "reduced": [],
                             "why": "dummy"})
    bench["workloads"].append({"name": "case141_mappo.train2048", "config": "case141_mappo",
                               "traffic": "train2048", "chips": 1, "why": "dummy"})
    bench["end_to_end"][0]["workloads"].append("case141_mappo.train2048")
    bench["per_layer"].append({"name": "dummy_ms", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "trainer rollout",
                               "moves": "train_env_steps_per_s",
                               "workloads": ["case141_mappo.train2048"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.cell("case141_mappo.train2048", root=str(root))
    assert c["config"]["grid"]["n_bus"] == 141 and c["traffic"]["lanes"] == 2048
    assert [m["name"] for m in c["per_layer"]] == ["dummy_ms"]
    assert spec.reader("dummy_ms", root=str(root))({"x": 2.5}) == 2.5
    # the cells already there see nothing new
    assert "dummy_ms" not in [m["name"] for m in spec.cell("case33_mappo.train512",
                                                              root=str(root))["per_layer"]]


DUMMY_KIND = """
import time
import numpy as np
import torch
from perfbench import traffic


class Runner:
    kind = "matvec"

    def __init__(self, cell, seed, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.sync = traffic.sync_of(self.device)
        self.alg = traffic.alg_of(cell)

    def setup(self):
        n = self.cell["traffic"]["n"]
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.a = torch.randn(n, n, generator=gen, device=self.device, dtype=torch.float64)
        self.x = torch.randn(n, generator=gen, device=self.device, dtype=torch.float64)

    def first_steps(self, rng):
        return 0.0

    def window(self, seconds):
        n, t0 = 0, time.perf_counter()
        while n == 0 or time.perf_counter() - t0 < seconds:
            self.y = self.a @ self.x
            n += 1
        return {"metrics": {"matvecs_per_s": n / (time.perf_counter() - t0)},
                "attempted": n, "failed": 0, "seconds": time.perf_counter() - t0}

    def trace(self, seconds, peaks):
        self.window(seconds)
        return {"x": 1.5, "profile": {"busy_s": 0.1, "window_s": 0.2,
                                      "breakdown": {"device_ops": [], "idle_gaps": []}}}

    def keep(self):
        self.kept = (self.a.cpu().numpy(), self.x.cpu().numpy(), self.y.cpu().numpy())

    def release(self):
        self.a = self.x = self.y = None

    def check(self, device, rng, control=False):
        a, x, y = self.kept
        return {"gap": float(np.abs(a @ x - y).max()), "leaves": len(self.alg.leaves({}))}

    def fault(self, name):
        raise ValueError(name)
"""


def test_kind_and_alg_added_by_files_alone(tmp_path):
    """A new kind of traffic (perfbench/kinds/) and a new algorithm
    (perfbench/algs/), each a new file, with a mix, a configuration, a cell
    and their entries: a whole run of the cell on the CPU through the
    harness as it is, its result line and its check."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(spec.ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "perfbench/kinds/matvec.py").write_text(DUMMY_KIND)
    (root / "perfbench/algs/noalg.py").write_text("def leaves(dims):\n    return {'none': []}\n")
    (root / "perfbench/traffic/matvec64.json").write_text(
        json.dumps({"kind": "matvec", "n": 64, "why": "dummy"}))
    (root / "perfbench/configs/dense64.json").write_text(
        json.dumps({"name": "dense64", "flags": ["--alg", "noalg"], "reduced": []}))
    (root / "perfbench/workloads/dense64.matvec64.json").write_text(
        json.dumps({"check": {}, "limits": {"gap": 1e-9, "leaves": 1}}))
    (root / "perfbench/metrics/x_share.py").write_text("def read(rec):\n    return rec.get('x')\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "dense64", "source": "https://example.org",
                             "file": "perfbench/configs/dense64.json", "reduced": [],
                             "why": "dummy"})
    bench["workloads"].append({"name": "dense64.matvec64", "config": "dense64",
                               "traffic": "matvec64", "chips": 1, "why": "dummy"})
    bench["end_to_end"].append({"name": "matvecs_per_s", "unit": "1/s", "better": "higher",
                                "bound": 0.1, "source": "host_clock",
                                "workloads": ["dense64.matvec64"]})
    bench["per_layer"].append({"name": "x_share", "unit": "%", "better": "higher",
                               "source": "program_counter", "layer": "matvec",
                               "moves": "matvecs_per_s", "workloads": ["dense64.matvec64"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.cell("dense64.matvec64", root=str(root))
    result, _ = harness.run("dense64.matvec64", 3, 0.05, 0, device="cpu", cell=cell)
    assert result["correct"] and result["attempted"] >= 1
    assert set(result["metrics"]) == {"matvecs_per_s", "setup_s"}
    assert result["checks"]["gap"]["value"] < 1e-9
    traced, _ = harness.run("dense64.matvec64", 3, 0.05, 1, device="cpu", cell=cell)
    assert traced["metrics"] == {"x_share": {"value": 1.5, "unit": "%"}}
