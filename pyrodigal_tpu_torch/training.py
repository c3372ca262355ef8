"""The training model (`TrainingInfo`).

Backed by a single contiguous buffer binary-compatible with the Prodigal
`-t` training file on x86-64 (reference: prodigal/training.pxd:1-15,
lib.pyx:3896-4885; struct size 558,392 bytes).
"""

import numpy as np

from ._constants import TRANSLATION_TABLES

TRAINING_STRUCT_SIZE = 558392

# byte offsets of the fields in the (x86-64) struct layout
_OFF_GC = 0
_OFF_TT = 8
_OFF_ST_WT = 16
_OFF_BIAS = 24
_OFF_TYPE_WT = 48
_OFF_USES_SD = 72
_OFF_RBS_WT = 80
_OFF_UPS_COMP = 304
_OFF_MOT_WT = 1328
_OFF_NO_MOT = 525616
_OFF_GENE_DC = 525624


class TrainingInfo:
    """A collection of parameters obtained after training.

    The binary codec is bit-compatible with Prodigal's ``-t`` training
    files (a raw 558,392-byte `_training` struct; reference:
    lib.pyx:3910-3953).

    Example:
        >>> from pyrodigal_tpu_torch import TrainingInfo
        >>> tinf = TrainingInfo(0.42)
        >>> tinf.gc
        0.42
        >>> tinf.translation_table
        11
        >>> tinf.start_weight
        4.35
        >>> sorted(tinf.to_dict())[:3]
        ['bias', 'coding_statistics', 'gc']
    """

    def __init__(
        self,
        gc,
        *,
        translation_table=11,
        start_weight=4.35,
        bias=None,
        type_weights=None,
        uses_sd=True,
        rbs_weights=None,
        upstream_compositions=None,
        motif_weights=None,
        missing_motif_weight=0.0,
        coding_statistics=None,
    ):
        self._data = np.zeros(TRAINING_STRUCT_SIZE, dtype=np.uint8)
        self.gc = gc
        self.translation_table = translation_table
        self.start_weight = start_weight
        if bias is not None:
            self.bias = bias
        if type_weights is not None:
            self.type_weights = type_weights
        self.uses_sd = uses_sd
        if rbs_weights is not None:
            self.rbs_weights = rbs_weights
        if upstream_compositions is not None:
            self.upstream_compositions = upstream_compositions
        if motif_weights is not None:
            self.motif_weights = motif_weights
        self.missing_motif_weight = missing_motif_weight
        if coding_statistics is not None:
            self.coding_statistics = coding_statistics

    # --- raw accessors --------------------------------------------------------

    @property
    def raw(self):
        """The raw struct buffer (ctypes-compatible)."""
        return self._data

    def _f64(self, offset, count):
        return self._data[offset:offset + 8 * count].view(np.float64)

    def _i32(self, offset):
        return self._data[offset:offset + 4].view(np.int32)

    # --- properties (same surface as the reference) ---------------------------

    @property
    def gc(self):
        return float(self._f64(_OFF_GC, 1)[0])

    @gc.setter
    def gc(self, value):
        if value > 1.0 or value < 0.0:
            raise ValueError(f"{value!r} is not a valid GC percent")
        self._f64(_OFF_GC, 1)[0] = value

    @property
    def translation_table(self):
        return int(self._i32(_OFF_TT)[0])

    @translation_table.setter
    def translation_table(self, table):
        if table not in TRANSLATION_TABLES:
            raise ValueError(f"{table!r} is not a valid translation table index")
        self._i32(_OFF_TT)[0] = table

    @property
    def start_weight(self):
        return float(self._f64(_OFF_ST_WT, 1)[0])

    @start_weight.setter
    def start_weight(self, value):
        self._f64(_OFF_ST_WT, 1)[0] = value

    @property
    def bias(self):
        return self._f64(_OFF_BIAS, 3)

    @bias.setter
    def bias(self, value):
        self._f64(_OFF_BIAS, 3)[:] = value

    @property
    def type_weights(self):
        return self._f64(_OFF_TYPE_WT, 3)

    @type_weights.setter
    def type_weights(self, value):
        self._f64(_OFF_TYPE_WT, 3)[:] = value

    @property
    def uses_sd(self):
        return bool(self._i32(_OFF_USES_SD)[0])

    @uses_sd.setter
    def uses_sd(self, value):
        self._i32(_OFF_USES_SD)[0] = bool(value)

    @property
    def rbs_weights(self):
        return self._f64(_OFF_RBS_WT, 28)

    @rbs_weights.setter
    def rbs_weights(self, value):
        self._f64(_OFF_RBS_WT, 28)[:] = value

    # alias used internally for ctypes calls
    @property
    def rbs_weights_array(self):
        return self._f64(_OFF_RBS_WT, 28)

    @property
    def upstream_compositions(self):
        return self._f64(_OFF_UPS_COMP, 32 * 4).reshape(32, 4)

    @upstream_compositions.setter
    def upstream_compositions(self, value):
        self._f64(_OFF_UPS_COMP, 32 * 4).reshape(32, 4)[:] = value

    @property
    def motif_weights(self):
        return self._f64(_OFF_MOT_WT, 4 * 4 * 4096).reshape(4, 4, 4096)

    @motif_weights.setter
    def motif_weights(self, value):
        self._f64(_OFF_MOT_WT, 4 * 4 * 4096).reshape(4, 4, 4096)[:] = value

    @property
    def missing_motif_weight(self):
        return float(self._f64(_OFF_NO_MOT, 1)[0])

    @missing_motif_weight.setter
    def missing_motif_weight(self, value):
        self._f64(_OFF_NO_MOT, 1)[0] = value

    @property
    def coding_statistics(self):
        return self._f64(_OFF_GENE_DC, 4096)

    @coding_statistics.setter
    def coding_statistics(self, value):
        self._f64(_OFF_GENE_DC, 4096)[:] = value

    # --- magic ---------------------------------------------------------------

    def __repr__(self):
        ty = type(self)
        return (
            f"<{ty.__module__}.{ty.__name__} gc={self.gc!r} "
            f"start_weight={self.start_weight!r} "
            f"translation_table={self.translation_table!r} "
            f"uses_sd={self.uses_sd!r}>"
        )

    def __getstate__(self):
        return self.to_dict()

    def __setstate__(self, state):
        self._data = np.zeros(TRAINING_STRUCT_SIZE, dtype=np.uint8)
        self.gc = state["gc"]
        self.translation_table = state["translation_table"]
        self.start_weight = state["start_weight"]
        self.bias = state["bias"]
        self.type_weights = state["type_weights"]
        self.uses_sd = state["uses_sd"]
        self.rbs_weights = state["rbs_weights"]
        self.upstream_compositions = state["upstream_compositions"]
        self.motif_weights = state["motif_weights"]
        self.missing_motif_weight = state["missing_motif_weight"]
        self.coding_statistics = state["coding_statistics"]

    # --- serialization --------------------------------------------------------

    def to_dict(self):
        return {
            "gc": self.gc,
            "translation_table": self.translation_table,
            "start_weight": self.start_weight,
            "bias": self.bias.tolist(),
            "type_weights": self.type_weights.tolist(),
            "uses_sd": self.uses_sd,
            "rbs_weights": self.rbs_weights.tolist(),
            "upstream_compositions": self.upstream_compositions.tolist(),
            "motif_weights": self.motif_weights.tolist(),
            "missing_motif_weight": self.missing_motif_weight,
            "coding_statistics": self.coding_statistics.tolist(),
        }

    def dump(self, fp):
        """Write the raw training struct (Prodigal `-t` compatible)."""
        fp.write(self._data.tobytes())

    @classmethod
    def load(cls, fp):
        """Read a raw training struct (Prodigal `-t` compatible)."""
        contents = fp.read(TRAINING_STRUCT_SIZE)
        if len(contents) != TRAINING_STRUCT_SIZE:
            raise EOFError(
                f"Expected {TRAINING_STRUCT_SIZE} bytes, only read {len(contents)}"
            )
        tinf = cls(0.50)
        tinf._data[:] = np.frombuffer(contents, dtype=np.uint8)
        return tinf
