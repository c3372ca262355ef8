"""Dynamic-programming nodes as a struct-of-arrays numpy container.

Mirrors the behaviour of the reference `Nodes`/`Node` classes
(reference: lib.pyx:1434-2596) with a SoA layout shared with the C engine
and the JAX pipelines.
"""

import ctypes

import numpy as np

from ._constants import MIN_GENE, MIN_EDGE_GENE, NODE_TYPE_NAMES, STOP
from . import _native


class Node:
    """A view over one node in a `Nodes` container."""

    __slots__ = ("owner", "index_")

    def __init__(self, owner, index):
        self.owner = owner
        self.index_ = index

    def __repr__(self):
        ty = type(self)
        return (
            f"<{ty.__module__}.{ty.__name__} index={self.index!r} "
            f"strand={self.strand:+} type={self.type!r} edge={self.edge!r}>"
        )

    @property
    def index(self):
        return int(self.owner.ndx[self.index_])

    @property
    def strand(self):
        return int(self.owner.strand[self.index_])

    @property
    def type(self):
        return ["ATG", "GTG", "TTG", "Stop"][int(self.owner.type[self.index_])]

    @property
    def edge(self):
        return bool(self.owner.edge[self.index_])

    @property
    def gc_bias(self):
        return int(self.owner.gc_bias[self.index_])

    @property
    def cscore(self):
        return float(self.owner.cscore[self.index_])

    @property
    def gc_cont(self):
        return float(self.owner.gc_cont[self.index_])

    @property
    def score(self):
        return float(self.owner.score[self.index_])

    @property
    def rscore(self):
        return float(self.owner.rscore[self.index_])

    @property
    def sscore(self):
        return float(self.owner.sscore[self.index_])

    @property
    def tscore(self):
        return float(self.owner.tscore[self.index_])

    @property
    def uscore(self):
        return float(self.owner.uscore[self.index_])

    @property
    def stop_val(self):
        return int(self.owner.stop_val[self.index_])


_SCALAR_FIELDS = [name for name, *_ in _native.NODE_FIELDS]


class Nodes:
    """A list of dynamic programming nodes (SoA layout)."""

    def __init__(self):
        self.length = 0
        self.capacity = 0
        self._allocate(0)

    @classmethod
    def with_capacity(cls, capacity):
        nodes = cls()
        nodes._allocate(capacity)
        return nodes

    # --- storage -------------------------------------------------------------

    def _allocate(self, capacity):
        self.capacity = int(capacity)
        for name, dtype, _ctype, width in _native.NODE_FIELDS:
            shape = self.capacity * width
            old = getattr(self, name, None)
            arr = np.zeros(shape, dtype=dtype)
            if old is not None and old.size > 0:
                n = min(old.size, arr.size)
                arr[:n] = old[:n]
            setattr(self, name, arr)

    def _struct(self):
        arrays = {name: getattr(self, name) for name in _SCALAR_FIELDS}
        return _native.make_nodes_struct(arrays, self.length, self.capacity)

    def _addr_struct(self):
        """`_struct()` as a `_native.NodesAddr`, built several times faster
        (needs a capacity above 0)."""
        return _native.NodesAddr(
            *[_native.addr(getattr(self, name)) for name in _SCALAR_FIELDS],
            self.length, self.capacity)

    @classmethod
    def from_block(cls, block, length):
        """`length` nodes viewing a node block (`_native.node_block_offsets`),
        the C engine's one-allocation layout of them."""
        nodes = cls.__new__(cls)
        nodes.length = nodes.capacity = length
        off = _native.node_block_offsets(length).tolist()
        for (name, dtype, _c, width), o in zip(_native.NODE_FIELDS, off):
            setattr(nodes, name, np.frombuffer(block, dtype, length * width, o))
        return nodes

    def _set_length(self, n):
        self.length = int(n)

    def __len__(self):
        return self.length

    def __getitem__(self, index):
        if index < 0:
            index += self.length
        if index >= self.length or index < 0:
            raise IndexError("nodes index out of range")
        return Node(self, index)

    def __iter__(self):
        for i in range(self.length):
            yield Node(self, i)

    def __getstate__(self):
        return {
            "length": self.length,
            "arrays": {
                name: getattr(self, name)[: self.length * width].copy()
                for name, _d, _c, width in _native.NODE_FIELDS
            },
        }

    def __setstate__(self, state):
        self.length = 0
        self.capacity = 0
        self._allocate(state["length"])
        self.length = state["length"]
        for name, _d, _c, width in _native.NODE_FIELDS:
            getattr(self, name)[: self.length * width] = state["arrays"][name]

    def copy(self):
        new = Nodes.__new__(Nodes)
        new.__setstate__(self.__getstate__())
        return new

    def clear(self):
        for name, _d, _c, width in _native.NODE_FIELDS:
            getattr(self, name)[: self.length * width] = 0
        self.length = 0

    # --- algorithms ----------------------------------------------------------

    def extract(self, sequence, *, closed=False, min_gene=MIN_GENE,
                min_edge_gene=MIN_EDGE_GENE, translation_table=11):
        """Extract start/stop nodes (reference: lib.pyx:1905-2117)."""
        self.length = 0
        slen = sequence.slen
        if self.capacity == 0:
            est = (sequence.start_probability() + sequence.stop_probability())
            self._allocate(int(est * max(slen - sequence.unknown, 0)) + 256)
        mb = sequence.masks.begin
        me = sequence.masks.end
        while True:
            s = self._struct()
            nn = _native.lib.rc_extract_nodes(
                _native.u8(sequence.digits), slen, translation_table,
                int(closed), min_gene, min_edge_gene,
                _native.i32(mb), _native.i32(me), len(mb),
                ctypes.byref(s),
            )
            if nn >= 0:
                self.length = nn
                return nn
            self._allocate(max(self.capacity * 2, 1024))

    def sort(self):
        """Sort by position, forward strand first on ties
        (reference: Prodigal node.c compare_nodes)."""
        order = np.lexsort((-self.strand[: self.length], self.ndx[: self.length]))
        self._permute(order)
        return order

    def _permute(self, order):
        n = self.length
        for name, _d, _c, width in _native.NODE_FIELDS:
            arr = getattr(self, name)
            if width == 1:
                arr[:n] = arr[:n][order]
            else:
                view = arr[: n * width].reshape(n, width)
                view[:] = view[order]

    def stop_order(self):
        """Permutation grouping nodes by stop codon, for the scores writer
        (reference: Prodigal node.c stopcmp_nodes)."""
        n = self.length
        return np.lexsort(
            (self.ndx[:n], -self.strand[:n], self.stop_val[:n])
        )

    def reset_scores(self):
        s = self._struct()
        _native.lib.rc_reset_node_scores(ctypes.byref(s))

    def score_nodes(self, sequence, training_info, *, closed=False, is_meta=False):
        """Score start nodes (reference: lib.pyx:2331-2487)."""
        s = self._struct()
        _native.lib.rc_score_nodes(
            _native.u8(sequence.digits), sequence.slen, ctypes.byref(s),
            _native.u8(training_info.raw), int(closed), int(is_meta),
        )

    def record_overlapping_starts(self, training_info, flag, max_sam_overlap):
        s = self._struct()
        _native.lib.rc_record_overlapping_starts(
            ctypes.byref(s), _native.u8(training_info.raw),
            int(flag), int(max_sam_overlap),
        )

    def record_gc_bias(self, gc_plot, slen, training_info):
        s = self._struct()
        _native.lib.rc_record_gc_bias(
            _native.i8(gc_plot), int(slen), ctypes.byref(s),
            _native.u8(training_info.raw),
        )

    def dynamic_programming(self, training_info, final):
        s = self._struct()
        return _native.lib.rc_dynamic_programming(
            ctypes.byref(s), _native.u8(training_info.raw), int(final)
        )

    def eliminate_bad_genes(self, ipath, training_info):
        s = self._struct()
        _native.lib.rc_eliminate_bad_genes(
            ctypes.byref(s), int(ipath), _native.u8(training_info.raw)
        )
