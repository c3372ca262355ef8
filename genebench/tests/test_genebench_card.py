"""On the card only: a short run of each cell ends with a result line
whose `correct` is true, with the device named."""

import json
import os
import subprocess
import sys

import pytest

from genebench import harness


def _run(cell, tmp_path):
    return subprocess.run(
        [sys.executable, "genebench/run.py", "--workload", cell, "--seed",
         str(2**31 + 5), "--seconds", "2", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, HOME=str(tmp_path), TMPDIR=str(tmp_path)))


@pytest.mark.cuda
def test_a_short_run_of_each_cell_is_correct(card, tmp_path):
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        cells = [w["name"] for w in json.load(f)["workloads"]]
    for cell in cells:
        r = _run(cell, tmp_path)
        assert r.returncode == 0, r.stderr[-3000:]
        result = json.loads(r.stdout.strip().splitlines()[-1])
        assert result["correct"] is True, (cell, result["checks"])
        assert result["device"]["platform"] == "gpu"
        assert result["device"]["count"] == 1
