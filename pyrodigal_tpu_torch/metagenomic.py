"""Metagenomic bins: pre-trained models used in *meta* mode.

The reference ships 50 pre-trained Prodigal models compiled in from the
vendored `training.c` (reference: lib.pyx:4888-5069; metagenomic.pxd:22).
That data asset is absent from the reference snapshot (the vendor submodule
is empty) and cannot be fetched in this environment, so this module:

  * implements the full `MetagenomicBin`/`MetagenomicBins` machinery,
    user-extensible exactly like the reference (e.g. pyrodigal-gv style);
  * loads the built-in bins from a binary asset file
    (``models/metagenomic_bins.npz``) generated by `scripts/build_bins.py`
    from self-trained models over a GC/translation-table grid, following
    Prodigal's bin descriptor format ``idx|name|B|gc|tt|uses_sd``.

Any externally obtained Prodigal training files can be converted into the
asset to restore bit-parity with upstream meta mode.
"""

import gzip
import io
import os

import numpy as np

from .training import TrainingInfo, TRAINING_STRUCT_SIZE

NUM_META = 50

_ASSET = os.path.join(os.path.dirname(__file__), "models", "metagenomic_bins.npz")


class MetagenomicBin:
    """A pre-trained model with a description."""

    def __init__(self, training_info, description):
        if training_info is None:
            raise TypeError("training_info cannot be None")
        if description is None:
            raise TypeError("description cannot be None")
        if len(description.encode("ascii")) >= 500:
            raise ValueError("Description string too long")
        self.training_info = training_info
        self.description = description

    def __repr__(self):
        ty = type(self)
        return f"<{ty.__module__}.{ty.__name__} description={self.description!r}>"

    def __reduce__(self):
        return (MetagenomicBin, (self.training_info, self.description))


class MetagenomicBins:
    """An indexed list of `MetagenomicBin` to use in *meta* mode."""

    def __init__(self, iterable=()):
        self._objects = tuple(iterable)

    def __len__(self):
        return len(self._objects)

    def __getitem__(self, index):
        if isinstance(index, slice):
            return type(self)(self._objects[index])
        n = len(self._objects)
        if index < 0:
            index += n
        if index < 0 or index >= n:
            raise IndexError("metagenomic bins index out of range")
        return self._objects[index]

    def __iter__(self):
        return iter(self._objects)

    def __reduce__(self):
        return type(self), (list(self),)

    # --- asset I/O ------------------------------------------------------------

    @classmethod
    def load(cls, path):
        """Load bins from an ``.npz`` asset with `descriptions` (str array)
        and `structs` (uint8 array of shape (n, 558392))."""
        with np.load(path, allow_pickle=False) as data:
            descriptions = data["descriptions"]
            structs = data["structs"]
        bins = []
        for desc, raw in zip(descriptions, structs):
            tinf = TrainingInfo(0.5)
            tinf._data[:] = raw
            bins.append(MetagenomicBin(tinf, str(desc)))
        return cls(bins)

    def dump(self, path):
        descriptions = np.array([b.description for b in self._objects])
        structs = np.stack([b.training_info._data for b in self._objects])
        np.savez_compressed(path, descriptions=descriptions, structs=structs)


def _load_builtin():
    if os.path.exists(_ASSET):
        return MetagenomicBins.load(_ASSET)
    return MetagenomicBins()


METAGENOMIC_BINS = _load_builtin()
