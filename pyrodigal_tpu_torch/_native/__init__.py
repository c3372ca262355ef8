"""ctypes bindings to the refcore C engine.

The C engine implements the exact float64 Prodigal v2.6.3 semantics over
struct-of-arrays numpy buffers.  `_load` takes, in order:

* the object shipped beside this module (a wheel's build of
  `refcore.c`, with the build host's CPU flags in `librefcore.so.isa`),
  when this host has every flag it was compiled for;
* in a source tree, an object gcc builds at first use into
  `build/pyrodigal_tpu_torch/` at the top of the tree (nothing is
  written next to the source), rebuilt when the source is newer or the
  host lacks a CPU feature the build host had;

and raises otherwise.  An installed package never builds, so it needs no
compiler and writes nothing around itself.
"""

import ctypes
import os
import subprocess

import numpy as np

from .. import tracing

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "refcore.c")
_TOP = os.path.dirname(os.path.dirname(_DIR))
# the object a wheel ships beside this module
_SHIPPED = os.path.join(_DIR, "librefcore.so")
BUILD_DIR = os.path.join(_TOP, "build", "pyrodigal_tpu_torch")
_LIB = os.path.join(BUILD_DIR, "librefcore.so")


CFLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-fPIC"]
_ISA = _LIB + ".isa"


def _source_tree():
    """True in a checkout of the repository (its build files beside the
    package), where the C engine may be built; False in an install."""
    return all(os.path.exists(os.path.join(_TOP, f))
               for f in ("setup.py", "pyproject.toml"))


def _cpu_flags():
    """The host's CPU feature flags (Linux); None when undeterminable."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return set(line.split(":", 1)[1].split())
    except OSError:
        pass
    return None


def _build():
    os.makedirs(BUILD_DIR, exist_ok=True)
    # a per-process temporary name: concurrent first imports each build
    # their own object and the last atomic rename wins
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = ["gcc", *CFLAGS, "-shared", _SRC, "-o", tmp, "-lm"]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except subprocess.CalledProcessError:
        # toolchain without -march=native support
        cmd = ["gcc", "-O3", "-ffp-contract=off", "-fPIC", "-shared", _SRC,
               "-o", tmp, "-lm"]
        subprocess.run(cmd, check=True, capture_output=True)
    # record the build host's ISA so an object is never dlopen'd on a host
    # missing features -march=native compiled in (a mismatch would SIGILL
    # mid-call, which ctypes cannot intercept)
    flags = _cpu_flags()
    if flags is not None:
        with open(f"{_ISA}.{os.getpid()}.tmp", "w") as f:
            f.write(" ".join(sorted(flags)))
        os.replace(f"{_ISA}.{os.getpid()}.tmp", _ISA)
    os.replace(tmp, _LIB)


def _isa_compatible(isa, missing_ok=False):
    """False when the object whose CPU flags `isa` records came from a
    host with CPU features this host lacks; `missing_ok` when no record
    is there."""
    if not os.path.exists(isa):
        return missing_ok
    host = _cpu_flags()
    if host is None:
        return True
    try:
        with open(isa) as f:
            built = set(f.read().split())
    except OSError:
        return False
    return built <= host


def _load():
    source_tree = _source_tree()
    # a shipped object without its flag record is the wheel's own build
    # (setup.py writes the record when /proc/cpuinfo is readable)
    if (os.path.exists(_SHIPPED)
            and _isa_compatible(_SHIPPED + ".isa", missing_ok=True)
            and not (source_tree and os.path.getmtime(_SHIPPED)
                     < os.path.getmtime(_SRC))):
        return ctypes.CDLL(_SHIPPED)
    if not source_tree:
        reason = ("was built on a host with CPU features this machine "
                  "lacks" if os.path.exists(_SHIPPED) else "is missing")
        raise RuntimeError(
            f"pyrodigal_tpu_torch: the C engine {_SHIPPED} {reason}; "
            f"reinstall the package from a wheel built for this machine")
    if (not os.path.exists(_LIB)
            or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)
            or not _isa_compatible(_ISA)):
        _build()
    return ctypes.CDLL(_LIB)

with tracing.setup("setup.native"):
    _lib = _load()

c_i8p = ctypes.POINTER(ctypes.c_int8)
c_u8p = ctypes.POINTER(ctypes.c_uint8)
c_u16p = ctypes.POINTER(ctypes.c_uint16)
c_i32p = ctypes.POINTER(ctypes.c_int32)
c_f32p = ctypes.POINTER(ctypes.c_float)
c_f64p = ctypes.POINTER(ctypes.c_double)


class NodesStruct(ctypes.Structure):
    _fields_ = [
        ("ndx", c_i32p), ("stop_val", c_i32p),
        ("type", c_i8p), ("strand", c_i8p),
        ("edge", c_u8p), ("elim", c_u8p), ("gc_bias", c_u8p), ("ov_mark", c_i8p),
        ("rbs0", c_u8p), ("rbs1", c_u8p),
        ("mot_ndx", c_u16p), ("mot_len", c_u8p),
        ("mot_spacer", c_u8p), ("mot_spacendx", c_u8p), ("mot_score", c_f64p),
        ("gc_score", c_f64p), ("gc_cont", c_f32p),
        ("cscore", c_f64p), ("uscore", c_f64p), ("tscore", c_f64p),
        ("rscore", c_f64p), ("sscore", c_f64p), ("score", c_f64p),
        ("star_ptr", c_i32p), ("traceb", c_i32p), ("tracef", c_i32p),
        ("nn", ctypes.c_int32), ("capacity", ctypes.c_int32),
    ]


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


# field name -> (numpy dtype, ctype, width)
NODE_FIELDS = [
    ("ndx", np.int32, ctypes.c_int32, 1),
    ("stop_val", np.int32, ctypes.c_int32, 1),
    ("type", np.int8, ctypes.c_int8, 1),
    ("strand", np.int8, ctypes.c_int8, 1),
    ("edge", np.uint8, ctypes.c_uint8, 1),
    ("elim", np.uint8, ctypes.c_uint8, 1),
    ("gc_bias", np.uint8, ctypes.c_uint8, 1),
    ("ov_mark", np.int8, ctypes.c_int8, 1),
    ("rbs0", np.uint8, ctypes.c_uint8, 1),
    ("rbs1", np.uint8, ctypes.c_uint8, 1),
    ("mot_ndx", np.uint16, ctypes.c_uint16, 1),
    ("mot_len", np.uint8, ctypes.c_uint8, 1),
    ("mot_spacer", np.uint8, ctypes.c_uint8, 1),
    ("mot_spacendx", np.uint8, ctypes.c_uint8, 1),
    ("mot_score", np.float64, ctypes.c_double, 1),
    ("gc_score", np.float64, ctypes.c_double, 3),
    ("gc_cont", np.float32, ctypes.c_float, 1),
    ("cscore", np.float64, ctypes.c_double, 1),
    ("uscore", np.float64, ctypes.c_double, 1),
    ("tscore", np.float64, ctypes.c_double, 1),
    ("rscore", np.float64, ctypes.c_double, 1),
    ("sscore", np.float64, ctypes.c_double, 1),
    ("score", np.float64, ctypes.c_double, 1),
    ("star_ptr", np.int32, ctypes.c_int32, 3),
    ("traceb", np.int32, ctypes.c_int32, 1),
    ("tracef", np.int32, ctypes.c_int32, 1),
]


class NodesAddr(ctypes.Structure):
    """`NodesStruct` with each array as a plain address: the same C layout
    (a pointer a field, then `nn` and `capacity`), built from integers."""
    _fields_ = ([(name, ctypes.c_void_p) for name, *_ in NodesStruct._fields_
                 if name not in ("nn", "capacity")]
                + [("nn", ctypes.c_int32), ("capacity", ctypes.c_int32)])


def addr(arr):
    """The address of a writable, non-empty numpy array's data, faster
    than `arr.ctypes.data`."""
    return ctypes.addressof(ctypes.c_char.from_buffer(arr))


def make_nodes_struct(arrays, nn, capacity):
    """Build a NodesStruct pointing at the given dict of numpy arrays."""
    s = NodesStruct()
    for name, dtype, ctype, _w in NODE_FIELDS:
        setattr(s, name, _ptr(arrays[name], ctype))
    s.nn = nn
    s.capacity = capacity
    return s


# --- C signatures -------------------------------------------------------------
_NP = ctypes.POINTER(NodesStruct)

_lib.rc_max_gc_frame_plot.argtypes = [c_u8p, ctypes.c_int, c_i8p]
_lib.rc_extract_nodes.argtypes = [
    c_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, c_i32p, c_i32p, ctypes.c_int, _NP,
]
_lib.rc_extract_nodes.restype = ctypes.c_int
_lib.rc_reset_node_scores.argtypes = [_NP]
_lib.rc_calc_orf_gc.argtypes = [c_u8p, ctypes.c_int, _NP]
_lib.rc_raw_coding_score.argtypes = [c_u8p, ctypes.c_int, _NP, ctypes.c_void_p]
_lib.rc_rbs_score.argtypes = [c_u8p, ctypes.c_int, _NP, ctypes.c_void_p]
_lib.rc_shine_dalgarno_exact.argtypes = [
    c_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, c_f64p, ctypes.c_int]
_lib.rc_shine_dalgarno_exact.restype = ctypes.c_int
_lib.rc_shine_dalgarno_mm.argtypes = _lib.rc_shine_dalgarno_exact.argtypes
_lib.rc_shine_dalgarno_mm.restype = ctypes.c_int
_lib.rc_score_nodes.argtypes = [
    c_u8p, ctypes.c_int, _NP, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
_lib.rc_record_overlapping_starts.argtypes = [
    _NP, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
_lib.rc_record_gc_bias.argtypes = [c_i8p, ctypes.c_int, _NP, ctypes.c_void_p]
_lib.rc_gc_bias_counts.argtypes = [c_i8p, ctypes.c_int, _NP, c_f64p, c_i32p]
_lib.rc_dynamic_programming.argtypes = [_NP, ctypes.c_void_p, ctypes.c_int]
_lib.rc_dynamic_programming.restype = ctypes.c_int
_lib.rc_dp_finish.argtypes = [_NP]
_lib.rc_dp_finish.restype = ctypes.c_int
_lib.rc_eliminate_bad_genes.argtypes = [_NP, ctypes.c_int, ctypes.c_void_p]
_lib.rc_extract_genes.argtypes = [
    _NP, ctypes.c_int, c_i32p, c_i32p, c_i32p, c_i32p, ctypes.c_int]
_lib.rc_extract_genes.restype = ctypes.c_int
_lib.rc_tweak_final_starts.argtypes = [
    _NP, ctypes.c_int, c_i32p, c_i32p, c_i32p, c_i32p,
    ctypes.c_void_p, ctypes.c_int]
_lib.rc_calc_dicodon_gene.argtypes = [
    ctypes.c_void_p, c_u8p, ctypes.c_int, _NP, ctypes.c_int]
_lib.rc_calc_dicodon_gene_bg.argtypes = [
    ctypes.c_void_p, c_u8p, ctypes.c_int, _NP, ctypes.c_int,
    ctypes.POINTER(ctypes.c_int64)]
_lib.rc_dicodon_finalize.argtypes = [
    ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
    ctypes.POINTER(ctypes.c_int64)]
_lib.rc_train_starts_sd.argtypes = [c_u8p, ctypes.c_int, _NP, ctypes.c_void_p]
_lib.rc_train_starts_nonsd.argtypes = [c_u8p, ctypes.c_int, _NP, ctypes.c_void_p]
_lib.rc_determine_sd_usage.argtypes = [ctypes.c_void_p]
_lib.rc_calculate_confidence.argtypes = [ctypes.c_double, ctypes.c_double]
_lib.rc_calculate_confidence.restype = ctypes.c_double

# bin-independent precompute for the device scoring pipeline
_lib.rc_rbs_candidates.argtypes = [c_u8p, ctypes.c_int, _NP, c_i32p, c_i32p]
_lib.rc_ups_mers.argtypes = [c_u8p, ctypes.c_int, _NP, c_i8p]
_lib.rc_motif_candidates.argtypes = [c_u8p, ctypes.c_int, _NP, c_i32p]
_lib.rc_star_candidates.argtypes = [_NP, ctypes.c_int, ctypes.c_int, c_i32p]
_lib.rc_star_candidates.restype = ctypes.c_int
_lib.rc_stop_real.argtypes = [c_u8p, ctypes.c_int, _NP, ctypes.c_int, c_u8p]
_lib.rc_sd_cand_luts.argtypes = [c_i32p, c_i32p]
_lib.rc_edge_ups_flags.argtypes = [_NP, ctypes.c_int, ctypes.c_int, c_u8p]

# one bin's exact re-run on node blocks (meta-mode finishing)
_lib.rc_node_block_layout.argtypes = [ctypes.c_int, ctypes.c_void_p]
_lib.rc_node_block_layout.restype = ctypes.c_int64
_lib.rc_run_bin.argtypes = [
    ctypes.POINTER(NodesAddr), ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, c_f64p]
_lib.rc_run_bin.restype = ctypes.c_int
_lib.rc_finish_bin.argtypes = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int]
_lib.rc_finish_bin.restype = ctypes.c_int

lib = _lib


def node_block_offsets(nn):
    """A node block of `nn` nodes: each array's byte offset, in
    NODE_FIELDS order, then the block's size (int64, 27 entries)."""
    off = np.empty(len(NODE_FIELDS) + 1, np.int64)
    _lib.rc_node_block_layout(nn, off.ctypes.data)
    return off


def u8(arr):
    return _ptr(arr, ctypes.c_uint8)


def i8(arr):
    return _ptr(arr, ctypes.c_int8)


def i32(arr):
    return _ptr(arr, ctypes.c_int32)


def f64(arr):
    return _ptr(arr, ctypes.c_double)


def i64(arr):
    return _ptr(arr, ctypes.c_int64)
