"""A cell, a traffic mix and a per-layer metric are added by adding files
and entries: no file the harness already has is edited."""

import hashlib
import json
import shutil
import time

from qgbench import harness


def digest(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_new_cell_mix_and_metric_from_files_alone(tmp_path):
    shutil.copytree(harness.ROOT / "qgbench", tmp_path / "qgbench",
                    ignore=shutil.ignore_patterns(".jax_cache",
                                                  "__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    before = digest(tmp_path / "qgbench")
    q = tmp_path / "qgbench"

    config = harness.load_json(q / "configs" / "turbulence-2048.json")
    config["model"].update(M=32, P=32)
    (q / "configs" / "toy-32.json").write_text(json.dumps(config))
    (q / "costs" / "toy-32.py").write_text(
        (q / "costs" / "turbulence-2048.py").read_text())
    (q / "traffic" / "hourly.json").write_text(json.dumps(
        {"sample_interval_s": 3600, "save_results": True,
         "trace_intervals": 1, "check_intervals": 4}))
    (q / "limits" / "toy-32.hourly.json").write_text(
        (q / "limits" / "turbulence-2048.daily.json").read_text())
    (q / "metrics" / "interval_max_ms.py").write_text(
        "def read(r):\n    return 1e3 * max(r.interval_s)\n")

    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy-32", "source": "test",
                             "file": "qgbench/configs/toy-32.json",
                             "reduced": ["M", "P"], "why": "test"})
    bench["workloads"].append({"name": "toy-32.hourly", "config": "toy-32",
                               "traffic": "hourly", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "interval_max_ms", "unit": "ms",
                                "better": "lower", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["toy-32.hourly"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.load_cell("toy-32.hourly", tmp_path)
    assert cell.traffic["sample_interval_s"] == 3600
    assert "interval_max_ms" in cell.readers
    result = harness.run_cell(cell, 5, 0.2, False, time.perf_counter(),
                              rehearsal=True, log=lambda *a, **k: None)
    assert result["correct"] is True, result["checks"]
    assert "interval_max_ms" in result["metrics_found"]
    after = digest(tmp_path / "qgbench")
    assert {k: v for k, v in after.items() if k in before} == before
