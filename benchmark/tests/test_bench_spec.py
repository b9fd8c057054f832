"""BENCHMARK.json against the contract's static rules, and a cell added by
new files and entries alone, in a temporary copy."""

import json
import os
import re
import shutil
import subprocess
import sys


from benchmark.tests.conftest import ROOT, tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_spec_keys_names_and_files():
    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51
    bench = os.path.join(ROOT, "benchmark")
    configs = {c["name"]: c for c in spec["configs"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        with open(os.path.join(ROOT, c["file"])) as f:
            body = json.load(f)
        assert all(k in body and NAME.match(k) for k in c["reduced"])
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if "bound" in m:
            assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"]: w for w in spec["workloads"]}
    assert len({(w["config"], w["traffic"]) for w in spec["workloads"]}) == len(cells)
    for w in spec["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in configs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        for sub in (("traffic", w["traffic"]), ("limits", w["name"])):
            assert os.path.exists(os.path.join(bench, sub[0], sub[1] + ".json"))
        reported = [m for m in spec["end_to_end"] if w["name"] in m.get("workloads", cells)]
        assert len(reported) >= 2
    for m in spec["per_layer"]:
        readers = {m["name"], m["name"].split(".")[0]}
        assert m["moves"] in e2e and any(
            os.path.exists(os.path.join(bench, "metrics", r + ".py")) for r in readers)
        for name in m.get("workloads", []):
            assert name in e2e[m["moves"]].get("workloads", cells)
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_a_cell_and_a_metric_added_by_files_alone(tmp_path):
    """A throwaway configuration, mix, limits and per-layer metric, added
    as new files and entries in a copy, run with no edit to any file that
    was there."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    config = dict(tiny("sosp-14s"), name="tiny-sosp", learning_rate_note="a new key")
    (tmp_path / "benchmark" / "configs" / "tiny-sosp.json").write_text(json.dumps(config))
    traffic = json.loads((tmp_path / "benchmark" / "traffic" / "adam-fit.json").read_text())
    traffic.update(learning_rate=0.02, calibration_steps=300, check_steps=8)
    (tmp_path / "benchmark" / "traffic" / "adam-fit-fast.json").write_text(json.dumps(traffic))
    (tmp_path / "benchmark" / "limits" / "tiny-adam.json").write_text(
        (tmp_path / "benchmark" / "limits" / "sosp14-adam.json").read_text())
    (tmp_path / "benchmark" / "metrics" / "steps_in_window.py").write_text(
        "def read(ctx):\n    return float(ctx.driver.steps)\n")
    spec["configs"].append({"name": "tiny-sosp", "source": "test", "why": "test",
                            "file": "benchmark/configs/tiny-sosp.json", "reduced": []})
    spec["workloads"].append({"name": "tiny-adam", "config": "tiny-sosp",
                              "traffic": "adam-fit-fast", "chips": 1, "why": "test"})
    spec["end_to_end"][0]["workloads"].append("tiny-adam")
    next(m for m in spec["per_layer"] if m["name"] == "mfu.bank_step")["workloads"].append(
        "tiny-adam")
    spec["per_layer"].append({"name": "steps_in_window", "unit": "steps", "better": "higher",
                              "source": "host_clock", "layer": "optimizers",
                              "moves": "bank_step_ms", "workloads": ["tiny-adam"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    edited = [p for p, b in before.items() if p.read_bytes() != b and p.name != "BENCHMARK.json"]
    assert edited == []
    code = ("import json, sys; sys.path.insert(0, %r); sys.path.append(%r)\n"
            "from benchmark import harness\n"
            "print(json.dumps(harness.run(%r, 'tiny-adam', 11, 0.2, True, device='cpu')))\n"
            ) % (str(tmp_path), ROOT, str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["metrics"]["steps_in_window"]["value"] >= 300
    assert "mfu.bank_step" in result["metrics"]
