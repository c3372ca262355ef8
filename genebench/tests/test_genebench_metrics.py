"""The metric readers and the run's guards, on made-up inputs (no card):
the rate over the whole window, the idle share of a
made-up kernel timeline, the DP rooflines' bytes against hand counts,
the import guard's whole-name match, and a run that fails without a
card."""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from genebench import devtrace, harness, instrument, peaks

ROOT = harness.ROOT


def metric(name):
    return harness.load_metric(name)


def fake_run(calls, spans=(), counts=None, trace=None, dp=()):
    rec = types.SimpleNamespace(spans=list(spans), counts=counts or {},
                                dp_launches=list(dp))
    return harness.Run("cell", 12.5, calls, rec, {}, trace)


def call(start, end, bp, ok=True):
    return {"start": start, "end": end, "bp": bp, "ok": ok}


def test_rate_is_over_the_whole_window_to_the_last_call_end():
    # three calls, a gap between the second and third; the last ends late
    calls = [call(10.0, 11.0, 1_000_000), call(11.0, 12.5, 3_000_000),
             call(13.0, 16.0, 3_000_000)]
    got = metric("mbp_per_s").read(fake_run(calls))
    assert got == pytest.approx(7.0 / 6.0)      # 7 Mbp over 10.0 .. 16.0
    # not a mean or median of per-call rates (1, 2, 1)
    assert got != pytest.approx(np.median([1.0, 2.0, 1.0]))
    assert got != pytest.approx(np.mean([1.0, 2.0, 1.0]))


def test_setup_and_spans_per_mbp():
    calls = [call(0.0, 2.0, 2_000_000)]
    spans = [("prep", 0.0, 0.5, 1), ("prep", 0.1, 0.4, 2),
             ("finish", 1.0, 1.5, 1), ("sweep", 0.5, 1.0, 3),
             ("fallback", 0.5, 1.7, 2)]
    run = fake_run(calls, spans)
    assert metric("setup_s").read(run) == 12.5
    assert metric("prep.thread_s_per_mbp").read(run) == pytest.approx(0.4)
    assert metric("finish.thread_s_per_mbp").read(run) == \
        pytest.approx(0.25)
    assert metric("exact_route.thread_s_per_mbp").read(run) == \
        pytest.approx(0.6)
    assert metric("sweep.s_per_mbp").read(run) == pytest.approx(0.25)
    assert metric("finish.thread_s_per_mbp").read(
        fake_run(calls, spans[:2])) is None                 # no span


def _events(kernels, calls):
    ev = [{"ph": "X", "cat": "kernel", "name": n, "ts": a, "dur": b - a}
          for n, a, b in kernels]
    ev += [{"ph": "X", "cat": "user_annotation", "name": devtrace.CALL,
            "ts": a, "dur": b - a} for a, b in calls]
    ev.append({"ph": "X", "cat": "gpu_user_annotation", "name": "x",
               "ts": 0, "dur": 10**7})            # not device work
    return {"traceEvents": ev}


def test_idle_share_of_a_made_up_timeline():
    # window 1,000..11,000 us; kernels cover 2,000..3,000 (two overlap)
    # and 6,000..8,000 (one runs past the window's end: 10,500..12,000)
    kernels = [("dp_mega_kernel(int)", 2000, 2600), ("star_kernel", 2400, 3000),
               ("dp_mega_kernel(int)", 6000, 8000),
               ("other", 10_500, 12_000)]
    host = [100.0, 100.0 + 0.006]
    spans = [("sweep", 100.0002, 100.0015, 1), ("finish", 100.0025, 100.004, 1)]
    t = devtrace.Trace(_events(kernels, [(1000, 6000), (7000, 11_000)]),
                       host, spans, bp=2_000_000)
    assert t.window_s == pytest.approx(0.010)
    assert t.busy_s == pytest.approx(0.0010 + 0.0020 + 0.0005)
    run = fake_run([call(0, 1, 1)], trace=t)
    assert metric("device.idle_pct").read(run) == pytest.approx(65.0)
    # gaps: 1,000..2,000 (sweep open), 3,000..6,000 (finish open at its
    # middle), 8,000..10,500 (between the host's spans: the call)
    assert sorted(t.gaps, key=lambda g: -g[1]) == [
        ("finish", pytest.approx(0.003)),
        ("call, other host work", pytest.approx(0.0025)),
        ("sweep", pytest.approx(0.001))]
    b = t.breakdown()
    assert b["device_ops"][0] == ["dp_mega_kernel", pytest.approx(0.0026)]
    assert metric("device.kernel_ms_per_mbp").read(run) == \
        pytest.approx(1e3 * 0.0032 / 2.0)     # "other" is not the port's


def _mega_args(B, NT):
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32)      # noqa: E731
    f32 = lambda *s: torch.zeros(s, dtype=torch.float32)    # noqa: E731
    kind4 = torch.full((NT,), 4, dtype=torch.int32)         # no real node
    return [i32(NT), i32(NT), kind4, i32(NT), i32(NT), i32(NT),
            i32(NT // 1024), f32(B, NT), f32(B, NT), f32(B, NT),
            f32(3, B, NT), f32(3, B, NT), i32(3, B, NT), i32(3, B, NT),
            f32(B), 2048]


def test_mega_dp_roofline_bytes_by_hand():
    B, NT = 16, 4096
    ops = [instrument.operand(a) for a in _mega_args(B, NT)]
    m = metric("dp_mega_roofline")
    # inputs: 6 geometry rows of NT int32, NT/1024 tile counts, three
    # (B, NT) f32, four (3, B, NT) tables, st_wt (B,) f32; outputs: 4
    # (B, NT) int32
    by_hand = (6 * NT * 4 + (NT // 1024) * 4 + 3 * B * NT * 4
               + 4 * 3 * B * NT * 4 + B * 4) + 4 * B * NT * 4
    assert m.launch_bound(ops) == pytest.approx(
        by_hand / peaks.HBM_BYTES_PER_S)
    # the kernel's time in the trace sets the share
    t = types.SimpleNamespace(kernel_count=lambda *p: 1,
                              kernel_seconds=lambda *p: 1e-3)
    run = fake_run([call(0, 1, 1)], trace=t, dp=[("dp_mega", ops)])
    assert m.read(run) == pytest.approx(
        100 * by_hand / peaks.HBM_BYTES_PER_S / 1e-3)


def test_a_reader_with_nothing_to_read_returns_nothing():
    run = fake_run([])
    for name in ("mbp_per_s", "device.idle_pct",
                 "exact_route.thread_s_per_mbp",
                 "dp_mega_roofline",
                 "device.kernel_ms_per_mbp", "launches_per_mbp",
                 "finish.bins_per_contig"):
        assert metric(name).read(run) is None, name


def test_guard_matches_whole_top_level_names():
    assert harness.forbidden_modules(
        ["pyrodigal_tpu_torch", "pyrodigal_tpu_torch.ops", "jaxtyping",
         "numpy"]) == []
    assert harness.forbidden_modules(
        ["pyrodigal_tpu.ops", "jax", "jaxlib.xla_client", "flax.linen",
         "pyrodigal_tpu_torch"]) == ["flax.linen", "jax", "jaxlib.xla_client",
                                     "pyrodigal_tpu.ops"]


def test_run_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "genebench", "run.py"),
         "--workload", "meta.long_contigs", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        env=dict(os.environ, HOME=str(tmp_path), TMPDIR=str(tmp_path)))
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_run_fails_outside_a_checkout(tmp_path):
    """In a directory that holds only BENCHMARK.json and genebench/."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "genebench"), tmp_path / "genebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run(
        [sys.executable, "genebench/run.py", "--workload",
         "meta.long_contigs", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True,
        env=dict(os.environ, HOME=str(tmp_path), TMPDIR=str(tmp_path),
                 PYTHONPATH=""))
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "pyrodigal_tpu_torch" in r.stderr


def test_benchmark_json_names_a_reader_for_every_metric():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(metric(m["name"]).read)
