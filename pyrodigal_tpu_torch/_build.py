"""Build and load the hand-written CUDA kernels (`csrc/*.cu`).

The kernels expose plain C entry points (no PyTorch headers), so `nvcc`
compiles them in seconds: one `nvcc -c` per source, all started together,
then one link into a shared library that `ctypes` loads.  The build runs
at first use, under a lock, into `build/pyrodigal_tpu_torch/` beside the
package; a library newer than every source is reused.

`-fmad=false` keeps every float multiply and add separately rounded, as
the JAX reference computes them: a contracted FMA moves last bits, and
the star sweep's strict `>` and the DP's fixed-point quantisation can
flip on such a difference (the C engine builds with -ffp-contract=off
for the same reason).
"""

import collections
import ctypes
import glob
import os
import shutil
import subprocess
import threading

from . import tracing

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "pyrodigal_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libkernels.so")

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + [
    "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # table, codes, out, scratch, B, S, tiles_per_block, stream
    "dc_chain_launch": [_P] * 4 + [_I, ctypes.c_longlong, _I, _P],
    # x, out, scratch, B, S, tiles_per_block, stream
    "phase_cumsum_launch": [_P] * 3 + [_I, ctypes.c_longlong, _I, _P],
    # ndx, sv, kind4, edge, cs, rsc, usc, st_wt,
    # sp, opv1, val3, t_sv, t_ndx, B, NT, relk, max_overlap, geo_stride,
    # tile, rows_per_block, stream
    "star_launch": [_P] * 13 + [_I] * 7 + [_P],
    # ndx, sv, kind4, win_lo, ovlo, has_ov, tile_nn, cs, rsc, usc,
    # opv1, val3, t_sv, t_ndx, st_wt, score, traceb, ov, tbndx,
    # B, NT, fxs, stream
    "dp_mega_launch": [_P] * 19 + [_I, _I, _I, _P],
    # ndx, sv, kind4, win_lo, cs, rsc, usc, opv1, val3, t_sv, t_ndx, st_wt,
    # score, traceb, ov, tbndx, BT, n, stream
    "dp_std_launch": [_P] * 16 + [_I, _I, _P],
    # n: shared bytes of a std DP row of n nodes
    "dp_std_smem_bytes": [_I],
    # cscore, lfac, code, run2, run3, scratch, BT, n, geo_stride, tiles,
    # reset_val, seed, stream
    "seg_scan_launch": [_P] * 6 + [_I] * 4 + [ctypes.c_float] * 2 + [_P],
}

_lock = threading.Lock()
_lib = None
# what the last build in this process reported (chip_smoke prints it; the
# build's time is its `setup.kernels` span's)
BUILD_INFO = {"ptxas": ""}


def _nvcc():
    path = shutil.which("nvcc")
    home_nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "nvcc")
    if path is None and os.path.exists(home_nvcc):
        path = home_nvcc
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _stale():
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    deps = _sources() + glob.glob(os.path.join(CSRC, "*.cuh"))
    return any(os.path.getmtime(p) > built for p in deps)


def _compile():
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = os.getpid()
    objs, procs = [], []
    for src in _sources():
        obj = os.path.join(
            BUILD_DIR, f"{os.path.basename(src)[:-3]}.{tag}.o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate()[0] for p in procs]
    BUILD_INFO["ptxas"] = "".join(logs)
    failed = [(p.args[-1], log) for p, log in zip(procs, logs)
              if p.returncode != 0]
    try:
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{src}:\n{log[-4000:]}" for src, log in failed))
        tmp = f"{LIB_PATH}.{tag}.tmp"
        r = subprocess.run([nvcc, *ARCH, "-shared", "-o", tmp, *objs],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                               f"{(r.stdout + r.stderr)[-4000:]}")
        os.replace(tmp, LIB_PATH)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)


def lib():
    """The loaded kernel library, built on first use (a `setup.kernels`
    span, its attribute `built` True when nvcc ran)."""
    global _lib
    with _lock:
        if _lib is None:
            with tracing.setup("setup.kernels") as sp:
                sp.set(built=_stale())
                if sp.attrs["built"]:
                    _compile()
                so = ctypes.CDLL(LIB_PATH)
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(so, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                so.kernels_error_string.argtypes = [_I]
                so.kernels_error_string.restype = ctypes.c_char_p
            _lib = so
        return _lib


class LaunchCounts(dict):
    """Kernel launches: the total per kernel (the dict's own items) and,
    in `detail()`, per (kernel, device index, stream handle), so that a run
    over a mesh can show which shard launched what.  Bumped under a lock:
    the shards of a mesh launch from threads of their own."""

    def __init__(self, *names):
        super().__init__((name, 0) for name in names)
        self._detail = collections.Counter()
        self._lock = threading.Lock()

    def bump(self, name, device, stream):
        with self._lock:
            self[name] += 1
            self._detail[(name, device.index, stream)] += 1

    def reset(self):
        with self._lock:
            for name in self:
                self[name] = 0
            self._detail.clear()

    def detail(self):
        """A copy of the {(kernel, device index, stream handle): launches}
        tally."""
        with self._lock:
            return dict(self._detail)


def check(err, name):
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib().kernels_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")
