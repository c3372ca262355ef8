"""`correct` comes out true on a sound run and false with the timed path
broken underneath, once for each fault a cell can have, and the control
(the reference in bfloat16) fails the score comparison.  Runs are driven
on the CPU: the harness's look for a card is skipped (`device="cpu"`),
the finder's runner takes `device="cpu"` (each kernel wrapper runs its
plain twin), and the cells are temporary ones, small enough for a test,
added as a later PR would add them (`test_genebench_resolve.add_cell`).

Faults, each planted where the answer is produced, on both routes:
* a step that returns its state unchanged: the DP launch's best scores
  left at their start value;
* half of the batch left out: half the rows of each launch;
* an answer altered: one device score (+5), the winning bin;
* the exchange between chips: no cell runs on more than one chip.
"""

import argparse
import io
import json
import os

import numpy as np
import pytest

from genebench import generate, harness
from genebench.tests.test_genebench_resolve import LIMITS, TINY, add_cell

@pytest.fixture
def cpu_port(monkeypatch):
    import torch

    from pyrodigal_tpu_torch.ops import meta_cuda

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    init = meta_cuda.CudaMetaRunner.__init__

    def on_cpu(self, *args, device, **kwargs):
        init(self, *args, device="cpu", **kwargs)

    monkeypatch.setattr(meta_cuda.CudaMetaRunner, "__init__", on_cpu)
    return meta_cuda.CudaMetaRunner


MEGA_MIX = {"kind": "stream", "pool_calls": 1, "contigs_per_call": 2,
            "trace_calls": 1,
            "recipes": [{"source": "GCF_001457455.1_NCTC11397_genomic.fna.gz",
                         "rotate": True, "strand_each": True,
                         "cut": {"kind": "lognormal", "median": 2600,
                                 "sigma": 0.1, "min_len": 2200,
                                 "max_len": 3000}}]}


def drive(tmp_path, trace=0, mix=None):
    with open(os.path.join(harness.HERE, "configs",
                           "prodigal_meta.json")) as f:
        config = json.load(f)
    add_cell(tmp_path, "test.cell", "test_config", "test_mix", "test.calls",
             mix or TINY, LIMITS, config_params=config)
    args = argparse.Namespace(workload="test.cell", seed=2**31 + 11,
                              seconds=0.0, trace=trace)
    out, err = io.StringIO(), io.StringIO()
    code, result = harness.run(args, device="cpu", out=out, err=err,
                               root=str(tmp_path),
                               here=str(tmp_path / "genebench"))
    assert code == 0
    assert json.loads(out.getvalue().splitlines()[-1]) == result
    # the numbers compared and their limits: the last lines of stderr
    tail = err.getvalue().splitlines()[-len(result["checks"]):]
    assert all(line.startswith("check ") for line in tail)
    assert list(result)[-1] == "checks"
    return result


def failing(result):
    return {k for k, v in result["checks"].items()
            if v["value"] is None or v["value"] > v["limit"]}


def test_sound_meta_run_is_correct(tmp_path, cpu_port):
    result = drive(tmp_path, trace=1)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] == 1 and result["failed"] == 0
    assert result["metrics"]["test.calls"]["value"] == 1
    assert "prep.thread_s_per_mbp" in result["metrics"]


def _std(monkeypatch, runner, change):
    orig = runner._sweep_std

    def broken(self, work, geoms):
        best = np.array(orig(self, work, geoms), copy=True)
        change(best, len(work))
        return best

    monkeypatch.setattr(runner, "_sweep_std", broken)


def _mega(monkeypatch, runner, change):
    """The mega route (`_sweep_mega_multi`, (contigs, bin rows) scores)
    broken the same way; contigs over 2,048 bp ride it, as the port's
    own tests force it."""
    from pyrodigal_tpu_torch.ops import meta_cuda

    monkeypatch.setattr(meta_cuda, "SEQ_BUCKET", 2048)
    orig = runner._sweep_mega_multi

    def broken(self, items):
        best, *rest = orig(self, items)
        best = np.array(best, copy=True)
        change(best.T, best.shape[1])   # rows along the first axis
        return (best, *rest)

    monkeypatch.setattr(runner, "_sweep_mega_multi", broken)


def _unchanged(best, n):
    best[:] = -1.0                  # the DP's start value: no path


def _half(best, n):
    best[n // 2:] = -1.0


def _one_score(best, n):
    best[0] += 5.0


@pytest.mark.parametrize("route", ["std", "mega"])
@pytest.mark.parametrize("fault,change,caught", [
    # every bin then ties, so finishing re-runs them all: genes stay exact
    ("state_unchanged", _unchanged, {"score_gap"}),
    ("half_the_batch", _half, {"score_gap"}),
    ("one_score_altered", _one_score, {"score_gap"}),
])
def test_meta_fault_is_caught(tmp_path, cpu_port, monkeypatch, route, fault,
                              change, caught):
    (_std if route == "std" else _mega)(monkeypatch, cpu_port, change)
    result = drive(tmp_path, mix=MEGA_MIX if route == "mega" else None)
    assert result["correct"] is False
    assert caught <= failing(result), (fault, result["checks"])


def test_sound_mega_run_is_correct(tmp_path, cpu_port, monkeypatch):
    from pyrodigal_tpu_torch.ops import meta_cuda

    monkeypatch.setattr(meta_cuda, "SEQ_BUCKET", 2048)
    result = drive(tmp_path, mix=MEGA_MIX)
    assert result["correct"] is True, result["checks"]


def test_meta_altered_winner_is_caught(tmp_path, cpu_port, monkeypatch):
    orig = cpu_port._produce_winner

    def wrong_bin(self, seq, num_seq, cands, nodes_by_tt):
        best = max(cands, key=lambda c: c[1])[0]
        cands = [(b, s - 1e3 if b == best else s) for b, s in cands]
        return orig(self, seq, num_seq, cands, nodes_by_tt)

    monkeypatch.setattr(cpu_port, "_produce_winner", wrong_bin)
    result = drive(tmp_path)
    assert result["correct"] is False
    assert "gene_mismatch" in failing(result)


def test_control_comes_out_not_correct():
    """The reference with bfloat16 node scores, put in the program's
    place in the harness's own comparison with the cell's limits, comes
    out not correct on a call of the long cell: MIIJ01000039 whole, a
    quarter of its pool's calls on every seed."""
    from genebench.control import control_result
    from genebench.reference import engine

    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    _cell, config, _mix, limits = harness.resolve("meta.long_contigs",
                                                  bench)
    pool = [[("miij", generate.read_source("MIIJ01000039.fna.gz"))]]
    with engine.executor(2) as ex:
        correct, checks, facts = control_result(
            config, harness.load_mode(config["mode"]), pool, limits, ex)
    assert correct is False
    assert {n for n, _v, _l, w in checks if not w} == {"score_gap"}
    assert facts["pairs"] > 0
