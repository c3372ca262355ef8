"""A later PR adds a cell by adding files and entries: a temporary cell
with a configuration, a mode, a traffic mix, limits and a metric of its
own is found by name, with no edit to a file that is already there."""

import hashlib
import json
import os
import shutil
import types

import pytest

from genebench import generate, harness

ROOT = harness.ROOT
HERE = harness.HERE


def _digest(path):
    h = hashlib.sha256()
    for dirpath, dirs, files in sorted(os.walk(path)):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for name in sorted(files):
            with open(os.path.join(dirpath, name), "rb") as f:
                h.update(name.encode() + f.read())
    return h.hexdigest()


def add_cell(tmp, cell, config, mix, metric, mix_params, limits,
             config_params=None, reader=None):
    """A copy of the benchmark under `tmp` with one more cell, made only
    by adding entries to BENCHMARK.json and adding files."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    shutil.copytree(HERE, tmp / "genebench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    g = tmp / "genebench"
    cfg_file = f"genebench/configs/{config}.json"
    bench["configs"].append({"name": config, "source": "https://example.org",
                             "file": cfg_file, "reduced": [], "why": "test"})
    bench["workloads"].append({"name": cell, "config": config,
                               "traffic": mix, "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(cell)
    bench["per_layer"].append({
        "name": metric, "unit": "1", "better": "lower",
        "source": "program_counter", "layer": "host prep",
        "moves": "mbp_per_s", "workloads": [cell]})
    with open(tmp / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    if config_params is None:
        with open(os.path.join(HERE, "configs", "prodigal_meta.json")) as f:
            config_params = json.load(f)
    config_params = dict(config_params, name=config)
    for path, data in ((tmp / cfg_file, config_params),
                       (g / "traffic" / f"{mix}.json", mix_params),
                       (g / "checks" / f"{cell}.json", limits)):
        with open(path, "w") as f:
            json.dump(data, f)
    with open(g / "metrics" / f"{metric}.py", "w") as f:
        f.write(reader or "def read(run):\n    return len(run.calls)\n")
    return bench


TINY = {"kind": "stream", "pool_calls": 1, "contigs_per_call": 3,
        "trace_calls": 1,
        "recipes": [{"source": "GCF_001457455.1_NCTC11397_genomic.fna.gz",
                     "rotate": True, "strand_each": True,
                     "cut": {"kind": "lognormal", "median": 2000,
                             "sigma": 0.3, "min_len": 800,
                             "max_len": 3000}}]}
LIMITS = {"limits": {"gene_mismatch": 0, "score_pairs_off": 0,
                     "score_gap": 1.0}}


def test_a_new_cell_is_found_by_name(tmp_path):
    before = _digest(HERE), _digest(os.path.join(ROOT, "BENCHMARK.json"))
    with open(os.path.join(HERE, "configs", "prodigal_meta.json")) as f:
        params = dict(json.load(f), mode="tmp_mode")
    bench = add_cell(tmp_path, "tmp.cell", "tmp_config", "tmp_mix",
                     "tmp.calls", TINY, LIMITS, config_params=params)
    with open(tmp_path / "genebench" / "modes" / "tmp_mode.py", "w") as f:
        f.write("def finder(config):\n    return 'tmp'\n")
    cell, config, mix, limits = harness.resolve(
        "tmp.cell", bench, root=str(tmp_path),
        here=str(tmp_path / "genebench"))
    assert cell["config"] == "tmp_config" and config["name"] == "tmp_config"
    assert mix == TINY and limits == LIMITS
    mode = harness.load_mode(config["mode"],
                             str(tmp_path / "genebench" / "modes"))
    assert mode.finder(config) == "tmp"
    names = [m["name"] for m in harness.metrics_for("tmp.cell", bench, 1)]
    assert "tmp.calls" in names
    reader = harness.load_metric("tmp.calls",
                                 str(tmp_path / "genebench" / "metrics"))
    assert reader.read(types.SimpleNamespace(calls=[1, 2])) == 2
    calls = generate.make(7, mix)
    assert len(calls) == 1 and len(calls[0]) == 3
    # the cells already there are found as before
    assert harness.resolve("meta.long_contigs", bench, root=str(tmp_path),
                           here=str(tmp_path / "genebench"))[2] == \
        generate.load_mix("long_contigs")
    assert (_digest(HERE), _digest(os.path.join(ROOT, "BENCHMARK.json"))) \
        == before


def test_an_unknown_cell_is_refused():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with pytest.raises(harness.RunError):
        harness.resolve("no.such_cell", bench)
