"""A cell, a configuration, a traffic mix, a driver and a per-layer metric
dropped into a copy of the benchmark as new files and entries are found by
name, with no file of the copy edited: the copy's harness builds the new
cell, runs a short window through the new driver and the program and reads
the new metric."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent

SCRIPT = r"""
import json, sys, time, torch
sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[2])
import harness
cell = harness.load_cell("epl80_copy.short")
small = {"cfg": {"num_pix": 10}, "traffic": {"starts": 4, "check_rows": 4}}
result, lines = harness.run(cell, 21, 0.5, False, torch.device("cpu"), time.time(), small)
reader = harness.load_module("metrics", "steps_seen")
print(json.dumps({"correct": result["correct"], "traffic_steps": cell["traffic"]["steps"],
                  "driver": cell["driver"].NAME,
                  "per_layer": [m["name"] for m in cell["per_layer"]],
                  "read": reader.read({"steps": 7}, lambda: harness.list_file("steps_seen"))}))
"""


def test_new_files_are_found_by_name(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH, copy / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", copy / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}

    b = copy / "benchmark"
    for ext in ("json", "py"):
        shutil.copy(b / "configs" / f"epl80_lstsq.{ext}", b / "configs" / f"epl80_copy.{ext}")
    for name in ("epl80_lstsq.py", "epl80_lstsq.limits.json"):
        shutil.copy(b / "reference" / name, b / "reference" / name.replace("lstsq", "copy"))
    driver = (b / "drivers" / "map.py").read_text()
    (b / "drivers" / "map_copy.py").write_text(driver + "\nNAME = 'map_copy'\n")
    traffic = json.loads((b / "traffic" / "map_recipe.json").read_text())
    (b / "traffic" / "map_short.json").write_text(json.dumps(dict(traffic, steps=6,
                                                                  driver="map_copy")))
    (b / "metrics" / "steps_seen.py").write_text(
        "def read(ctx, names):\n    return ctx['steps'] * len(names())\n")
    (b / "metrics" / "steps_seen.txt").write_text("# two lines\na\nb\n")
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="epl80_copy",
                                 file="benchmark/configs/epl80_copy.json"))
    bench["workloads"].append({"name": "epl80_copy.short", "config": "epl80_copy",
                               "traffic": "map_short", "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "MAP loop",
                               "moves": "evals_per_s", "workloads": ["epl80_copy.short"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    for p, data in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == data, f"{p} was edited"

    out = subprocess.run([sys.executable, "-c", SCRIPT, str(b), str(REPO)], cwd=copy,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "traffic_steps": 6, "driver": "map_copy",
                   "per_layer": ["steps_seen"], "read": 14}
