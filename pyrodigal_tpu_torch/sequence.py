"""Digitized input sequences and region masks.

Mirrors the behaviour of the reference `Sequence`/`Mask`/`Masks` classes
(reference: lib.pyx:274-1073) with a numpy-native representation.
"""

import numpy as np

from ._constants import A, G, C, T, N, LETTERS, COMPLEMENT, MASK_SIZE, WINDOW
from . import _native

# ASCII byte -> digit lookup: A/a=0 G/g=1 C/c=2 T/t=3 everything else N=6
_DIGIT_LUT = np.full(256, N, dtype=np.uint8)
for _c, _d in ((b"Aa", A), (b"Gg", G), (b"Cc", C), (b"Tt", T)):
    _DIGIT_LUT[_c[0]] = _d
    _DIGIT_LUT[_c[1]] = _d


class Mask:
    """A masked region; begin-inclusive, end-exclusive (reference: lib.pyx:277)."""

    __slots__ = ("begin", "end")

    def __init__(self, begin, end):
        self.begin = int(begin)
        self.end = int(end)

    def __repr__(self):
        return (f"<pyrodigal_tpu_torch.Mask begin={self.begin!r} "
                f"end={self.end!r}>")

    def __eq__(self, other):
        if isinstance(other, Mask):
            return self.begin == other.begin and self.end == other.end
        return NotImplemented

    def intersects(self, begin, end):
        """(reference: lib.pyx:336-341)

        Example:
            >>> from pyrodigal_tpu_torch import Mask
            >>> Mask(5, 10).intersects(8, 20)
            True
            >>> Mask(5, 10).intersects(10, 20)   # end-exclusive
            False
        """
        return self.begin < end and begin < self.end


class Masks:
    """A list of masked regions within a `Sequence`."""

    def __init__(self, begins=(), ends=()):
        self.begin = np.asarray(begins, dtype=np.int32)
        self.end = np.asarray(ends, dtype=np.int32)

    def __len__(self):
        return len(self.begin)

    def __getitem__(self, index):
        n = len(self.begin)
        if index < 0:
            index += n
        if index >= n or index < 0:
            raise IndexError("masks index out of range")
        return Mask(self.begin[index], self.end[index])

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __getstate__(self):
        return [(int(b), int(e)) for b, e in zip(self.begin, self.end)]

    def __setstate__(self, state):
        self.begin = np.array([b for b, _ in state], dtype=np.int32)
        self.end = np.array([e for _, e in state], dtype=np.int32)

    def clear(self):
        self.begin = np.zeros(0, dtype=np.int32)
        self.end = np.zeros(0, dtype=np.int32)

    def copy(self):
        return Masks(self.begin.copy(), self.end.copy())


def _find_masks(digits, mask_size):
    """Runs of >= mask_size N's (reference: lib.pyx:699-713)."""
    isn = (digits == N).astype(np.int8)
    if isn.size == 0:
        return Masks()
    d = np.diff(isn)
    starts = np.flatnonzero(d == 1) + 1
    ends = np.flatnonzero(d == -1) + 1
    if isn[0]:
        starts = np.concatenate(([0], starts))
    if isn[-1]:
        ends = np.concatenate((ends, [isn.size]))
    keep = (ends - starts) >= mask_size
    # NB: the reference only mask-checks a trailing run against `mask_size`
    # when it is *closed* by a non-N character; a trailing run of N is always
    # masked (lib.pyx:711-712).
    if isn[-1] and len(starts) > 0:
        keep[-1] = True
    return Masks(starts[keep], ends[keep])


class Sequence:
    """A digitized input sequence (reference: lib.pyx:514-722).

    Example:
        >>> from pyrodigal_tpu_torch import Sequence
        >>> seq = Sequence("ACGTNacgt")
        >>> str(seq)
        'ACGTNACGT'
        >>> len(seq)
        9
        >>> round(seq.gc, 4)
        0.4444
    """

    def __init__(self, sequence, mask=False, mask_size=MASK_SIZE):
        if isinstance(sequence, Sequence):
            self.digits = sequence.digits.copy()
            self.gc = sequence.gc
            self.gc_known = sequence.gc_known
            self.unknown = sequence.unknown
        else:
            if isinstance(sequence, str):
                raw = sequence.encode("ascii", errors="replace")
            else:
                raw = bytes(sequence)
            buf = np.frombuffer(raw, dtype=np.uint8)
            self.digits = _DIGIT_LUT[buf]
            length = self.digits.shape[0]
            gc_count = int(np.count_nonzero((self.digits == G) | (self.digits == C)))
            self.unknown = int(np.count_nonzero(self.digits == N))
            self.gc = gc_count / length if length > 0 else 0.0
            self.gc_known = (
                gc_count / (length - self.unknown) if length > self.unknown else 0.0
            )
        if mask:
            self.masks = _find_masks(self.digits, mask_size)
        else:
            self.masks = Masks()

    @property
    def slen(self):
        return self.digits.shape[0]

    def __len__(self):
        return self.digits.shape[0]

    def __str__(self):
        return LETTERS[self.digits].tobytes().decode("ascii")

    def __getstate__(self):
        return {
            "slen": self.slen,
            "gc": self.gc,
            "gc_known": self.gc_known,
            "unknown": self.unknown,
            "masks": self.masks.__getstate__(),
            "digits": self.digits.tobytes(),
        }

    def __setstate__(self, state):
        self.digits = np.frombuffer(state["digits"], dtype=np.uint8).copy()
        self.gc = state["gc"]
        self.gc_known = state.get("gc_known", 0.0)
        self.unknown = state.get("unknown", 0)
        self.masks = Masks()
        self.masks.__setstate__(state["masks"])

    # --- probabilities (reference: lib.pyx:983-999) --------------------------

    def start_probability(self):
        gc = self.gc_known
        p_atg = (1 - gc) * (1 - gc) * gc / 8
        p_gtg = gc * (1 - gc) * gc / 8
        p_ttg = (1 - gc) * (1 - gc) * gc / 8
        return p_atg + p_gtg + p_ttg

    def stop_probability(self):
        gc = self.gc_known
        p_tga = (1 - gc) * (1 - gc) * gc / 8.0
        p_tag = (1 - gc) * gc * (1 - gc) / 8.0
        p_taa = (1 - gc) * (1 - gc) * (1 - gc) / 8.0
        return p_tga + p_tag + p_taa

    # --- GC frame plot -------------------------------------------------------

    def max_gc_frame_plot(self, window_size=WINDOW):
        if window_size < 0:
            raise ValueError(f"Invalid window size {window_size!r}")
        gp = np.empty(self.slen, dtype=np.int8)
        if self.slen:
            _native.lib.rc_max_gc_frame_plot(
                _native.u8(self.digits), self.slen, _native.i8(gp)
            )
        return gp

    # --- Shine-Dalgarno ------------------------------------------------------

    def shine_dalgarno(self, pos, start, training_info, strand=1, exact=True):
        if strand != 1 and strand != -1:
            raise ValueError(f"Invalid strand: {strand!r} (must be +1 or -1)")
        if pos < 0:
            raise ValueError("`pos` must be positive")
        if start < 0:
            raise ValueError("`start` must be positive")
        fn = (
            _native.lib.rc_shine_dalgarno_exact
            if exact
            else _native.lib.rc_shine_dalgarno_mm
        )
        return fn(
            _native.u8(self.digits), self.slen, pos, start,
            _native.f64(training_info.rbs_weights_array), strand,
        )
