"""The command's guards: without a card it exits non-zero and prints no
result; in a directory that holds only BENCHMARK.json and the
benchmark's files it exits non-zero and prints no result; a harness
run loads neither JAX nor the JAX package, and the reference loads
nothing of the port.  On a card, one short run prints the result line."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


def command(cwd, *args):
    return subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload", "dvo-fr1-forward",
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0", *args],
        cwd=cwd, capture_output=True, text=True, timeout=600)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = command(ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_only_the_benchmark_files_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = command(tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


SCRIPT = """
import sys
sys.path.insert(0, {root!r})
{body}
names = {{m.split(".")[0] for m in sys.modules}}
print(sorted(names & {{"jax", "jaxlib", "flax", "tadataka_tpu",
                      "tadataka_torch"}}))
"""


def loaded_after(body):
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(root=str(ROOT), body=body)],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    return eval(proc.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    body = """
import io
from bench_port.harness import drive
from bench_port.tests.small import small
r = drive.run("dvo-fr1-forward", 5, 0.5, False, device="cpu",
              config_override=small, out=io.StringIO(), err=io.StringIO())
assert r["attempted"] > 0
"""
    assert loaded_after(body) == ["tadataka_torch"]


def test_the_reference_loads_nothing_of_the_port():
    body = """
import bench_port.reference.semi_dense_vo
import bench_port.reference.dvo_trajectory
import bench_port.harness.traffic
import bench_port.harness.roofline
"""
    assert loaded_after(body) == []


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = command(ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(result) >= {"correct", "attempted", "failed", "metrics",
                           "device"}
    assert result["device"]["platform"] == "gpu"
