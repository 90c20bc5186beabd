"""Build the CUDA kernels in ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface.  ``nvcc`` compiles it for
Hopper (``sm_90a``) into ``_build/lib<name>-<hash>.so``, named by the hash
of its source and flags so that an edited source is never served by an old
library, and ``ctypes`` loads it.  Nothing is compiled when a module is
imported.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS = {}


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "%s with the CUDA toolkit" % SRC_DIR)


def _paths(name):
    src = SRC_DIR / ("%s.cu" % name)
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / ("lib%s-%s.so" % (name, digest))


def build_all(names=None):
    """Compile every kernel source not built yet, one ``nvcc`` for each,
    all started together.  Returns ``{name: compiler output}`` for the
    sources it compiled (``-Xptxas -v``: registers, shared memory, spills).
    """
    if names is None:
        names = sorted(p.stem for p in SRC_DIR.glob("*.cu"))
    jobs = {}
    for name in names:
        src, lib = _paths(name)
        if lib.exists():
            continue
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = lib.with_name("%s.%d.tmp" % (lib.name, os.getpid()))
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, lib)
    logs = {name: proc.communicate()[0]
            for name, (proc, _, _) in jobs.items()}
    failed = [name for name, (proc, _, _) in jobs.items()
              if proc.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            "%s:\n%s" % (name, logs[name]) for name in failed))
    for proc, tmp, lib in jobs.values():
        os.replace(tmp, lib)   # atomic: another process may load it
    return logs


def load(name):
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        _, path = _paths(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib
