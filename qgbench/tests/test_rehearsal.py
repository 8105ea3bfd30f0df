"""CPU rehearsal of each cell's whole data path through run_model, at a
toy grid (four virtual devices for the four-card cell). A rehearsal puts
no metric values in its result: no CPU number goes out under a device
metric's name."""

import io
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

import pytest

from qgbench import harness

ROOT = harness.ROOT
TOY = {"model": {"M": 32, "P": 32}}
CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def benchmark():
    return harness.load_json(ROOT / "BENCHMARK.json")


def metric_names(cell_name, kind):
    return sorted(m["name"] for m in benchmark()[kind]
                  if cell_name in m.get("workloads", [cell_name]))


def rehearse(cell_name, trace=False, **kw):
    cell = harness.load_cell(cell_name)
    return harness.run_cell(cell, 2 ** 31 + 7, 0.3, trace,
                            time.perf_counter(), rehearsal=True,
                            overrides=TOY, log=lambda *a, **k: None, **kw)


@pytest.mark.parametrize("cell_name", [w["name"] for w in
                                       benchmark()["workloads"]])
@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal(cell_name, trace):
    result = rehearse(cell_name, trace)
    assert list(result)[:5] == CONTRACT_KEYS
    assert list(result)[-1] == "checks"
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 2
    assert result["metrics"] == {}
    assert result["rehearsal"] is True
    kind = "per_layer" if trace else "end_to_end"
    assert result["metrics_found"] == metric_names(cell_name, kind)
    chips = {w["name"]: w["chips"] for w in benchmark()["workloads"]}
    assert result["device"]["count"] == chips[cell_name]
    assert "busy_s" not in result["device"]
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}


def test_report_prints_checks_last_on_stderr_and_result_last_on_stdout():
    result = {"correct": True, "attempted": 2, "failed": 0, "metrics": {},
              "device": {}, "checks": {"zeta_err": {"value": 1e-7,
                                                    "limit": 1e-5}}}
    out, err = io.StringIO(), io.StringIO()

    def log(*args, file=None, **kw):
        print(*args, file=err if file is sys.stderr else out, **kw)

    harness.report(result, log=log)
    assert json.loads(out.getvalue().splitlines()[-1]) == result
    assert err.getvalue().splitlines()[-2].startswith("check zeta_err ")
    assert "limit 1e-05" in err.getvalue().splitlines()[-2]


def run_cli(cwd, env_extra=None):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", **(env_extra or {})}
    return subprocess.run(
        [sys.executable, "qgbench/run.py", "--workload",
         "turbulence-2048.daily", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def test_cli_without_a_gpu_exits_nonzero_and_prints_no_result():
    proc = run_cli(ROOT)
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
    assert "correct" not in proc.stdout


def test_cli_with_only_the_benchmark_files_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "qgbench", tmp_path / "qgbench",
                    ignore=shutil.ignore_patterns(".jax_cache",
                                                  "__pycache__"))
    proc = run_cli(tmp_path)
    assert proc.returncode != 0
    assert "correct" not in proc.stdout
