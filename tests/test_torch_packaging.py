"""Wheel packaging of the PyTorch port, the twin of tests/test_packaging.py:
the built wheel carries the port's own compiled C engine, and an install
imports and runs `backend="refcore"` on a host with no toolchain, without
writing a `build/` directory around itself."""

import os
import shutil
import subprocess
import sys
import zipfile

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = (
    "import shutil; assert shutil.which('gcc') is None\n"
    "import pyrodigal_tpu_torch\n"
    "assert pyrodigal_tpu_torch.__file__.startswith({inst!r})\n"
    "from pyrodigal_tpu_torch import GeneFinder\n"
    "g = GeneFinder(meta=True, backend='refcore').find_genes("
    "'AATGTAGGAAAAACAGCATTTTCATTTCGCCATTTT' * 30)\n"
    "print(len(g))\n"
)


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    """A wheel built from a copy of the source tree (so that it shares no
    build directory with another build of the repository)."""
    tmp = tmp_path_factory.mktemp("torch_wheel")
    src = tmp / "src"
    src.mkdir()
    skip = shutil.ignore_patterns("__pycache__", "*.so", "*.so.isa",
                                  "*.egg-info", "*.tmp")
    for name in ("setup.py", "pyproject.toml", "README.md"):
        shutil.copy(os.path.join(REPO, name), src / name)
    for pkg in ("pyrodigal_tpu", "pyrodigal_tpu_torch"):
        shutil.copytree(os.path.join(REPO, pkg), src / pkg, ignore=skip)
    r = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", ".", "--no-deps",
         "--no-build-isolation", "-w", str(tmp / "wheelhouse")],
        cwd=str(src), capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-2000:]
    (whl,) = (tmp / "wheelhouse").glob("*.whl")
    return whl


def _install(whl, where):
    zipfile.ZipFile(whl).extractall(where)
    return where


def _run_without_gcc(inst, cwd):
    env = dict(os.environ, PATH="/nonexistent", PYTHONPATH=str(inst),
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", PROBE.format(inst=str(inst))],
                          env=env, cwd=str(cwd), capture_output=True,
                          text=True)


@pytest.mark.skipif(not os.path.exists(os.path.join(REPO, "setup.py")),
                    reason="not running from a source tree")
def test_wheel_ships_the_ports_engine(wheel):
    names = zipfile.ZipFile(wheel).namelist()
    for name in ("pyrodigal_tpu_torch/_native/librefcore.so",
                 "pyrodigal_tpu_torch/_native/librefcore.so.isa",
                 "pyrodigal_tpu_torch/_native/refcore.c",
                 "pyrodigal_tpu_torch/py.typed",
                 "pyrodigal_tpu_torch/__init__.pyi",
                 "pyrodigal_tpu_torch/models/metagenomic_bins.npz",
                 "pyrodigal_tpu_torch/csrc/star.cu"):
        assert name in names, name
    entry = [n for n in names if n.endswith("entry_points.txt")]
    text = zipfile.ZipFile(wheel).read(entry[0]).decode()
    assert "pyrodigal_tpu_torch = pyrodigal_tpu_torch.cli:run" in text


@pytest.mark.skipif(not os.path.exists(os.path.join(REPO, "setup.py")),
                    reason="not running from a source tree")
def test_installed_port_runs_without_gcc(wheel, tmp_path):
    inst = _install(wheel, tmp_path / "inst")
    r = _run_without_gcc(inst, tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "1"
    # the install tree holds what the wheel put there, and nothing built
    assert not (tmp_path / "build").exists()
    assert not (inst / "build").exists()


@pytest.mark.skipif(not os.path.exists(os.path.join(REPO, "setup.py")),
                    reason="not running from a source tree")
def test_installed_port_without_its_engine_says_why(wheel, tmp_path):
    """An install whose shipped engine is gone raises a clear error at
    import, and never tries a compiler or writes a build directory."""
    inst = _install(wheel, tmp_path / "inst")
    os.remove(inst / "pyrodigal_tpu_torch" / "_native" / "librefcore.so")
    r = _run_without_gcc(inst, tmp_path)
    assert r.returncode != 0
    assert "RuntimeError" in r.stderr and "librefcore.so" in r.stderr
    assert "is missing" in r.stderr
    assert not (tmp_path / "build").exists()
    assert not (inst / "build").exists()
