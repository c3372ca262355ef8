"""Build shim: compiles the refcore C engine as a shared object shipped
inside the wheel (loaded through ctypes, never imported as a module).

The reference project drives its native build through scikit-build-core +
CMake (reference: CMakeLists.txt, pyproject.toml); here a single C file
with no Python API keeps a plain setuptools Extension sufficient.
"""

from setuptools import setup
from setuptools.command.build_ext import build_ext
from setuptools.extension import Extension


class BuildRefcore(build_ext):
    def get_export_symbols(self, ext):
        # plain C library: no PyInit_* entry point to export
        return []

    def get_ext_filename(self, fullname):
        # fixed name so the ctypes loader finds it without ABI suffixes
        import os

        return os.path.join(*fullname.split(".")) + ".so"

    def build_extension(self, ext):
        super().build_extension(ext)
        # record the build host's ISA next to the object so the ctypes
        # loader refuses (or rebuilds) instead of SIGILL-ing when a
        # -march=native wheel lands on a host missing those features
        import os

        try:
            with open("/proc/cpuinfo") as f:
                flags = None
                for line in f:
                    if line.startswith(("flags", "Features")):
                        flags = sorted(set(line.split(":", 1)[1].split()))
                        break
        except OSError:
            flags = None
        if flags:
            so = self.get_ext_fullpath(ext.name)
            with open(so + ".isa", "w") as f:
                f.write(" ".join(flags))


# -march=native: the wheel is built for (and on) the deploy host; the
# ctypes loaders check the `.isa` record beside each object, so a shipped
# object only needs to match the build machine.  -ffp-contract=off keeps
# the float64 engine bit-identical across instruction sets (no FMA
# contraction).  One engine for each package: the PyTorch port carries
# its own copy of refcore.c.
REFCORE_FLAGS = ["-O3", "-march=native", "-ffp-contract=off"]

setup(
    ext_modules=[
        Extension(
            f"{pkg}._native.librefcore",
            sources=[f"{pkg}/_native/refcore.c"],
            extra_compile_args=REFCORE_FLAGS,
            libraries=["m"],
        )
        for pkg in ("pyrodigal_tpu", "pyrodigal_tpu_torch")
    ],
    cmdclass={"build_ext": BuildRefcore},
)
