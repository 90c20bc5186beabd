"""Build the CUDA kernels in ``csrc/`` at first use, load them, launch
them and count their launches.

Each ``csrc/<name>.cu`` has a plain C interface.  ``nvcc`` compiles it for
Hopper (``sm_90a``) into ``_build/lib<name>-<hash>.so``, named by the hash
of its source and flags so that an edited source is never served by an old
library, and ``ctypes`` loads it.  Nothing is compiled when a module is
imported.

Each exported C function the wrappers call is one :class:`Fn`, which
declares its ctypes signature once; :meth:`Fn.launch` runs a kernel on the
current stream, raises on a CUDA error and counts the launch in
:data:`LAUNCHES`; :class:`StructFn` launches a kernel that takes one
argument struct by value.
"""

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

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


# the CUDA kernels' launches since import (or since a caller reset a count),
# by kernel name: counted where a wrapper launches a kernel, never for a
# plain version; a replay of a CUDA graph adds the launches its capture
# recorded (models/graphs.py).  ``cin_mix_bwd_einsum`` counts the CIN
# backwards that took the einsums instead of their kernels.
LAUNCHES = collections.Counter()


class Fn:
    """The C function ``name`` exported by ``csrc/<lib>.cu``, its ctypes
    signature (``argtypes``, ``restype``) declared at first use.

    Calling it runs a size or plan query (no stream, no count);
    :meth:`launch` runs a kernel."""

    def __init__(self, lib, name, argtypes, restype=ctypes.c_int):
        self.lib, self.name = lib, name
        self.argtypes, self.restype = argtypes, restype
        self._fn = None

    def bind(self, lib=None):
        """The function of ``lib``, a loaded library built from the same
        source (a variant build a tool times), or of the built
        ``csrc/<lib>.cu`` by default, with its signature declared."""
        if lib is None:
            if self._fn is None:
                self._fn = self.bind(load(self.lib))
            return self._fn
        fn = getattr(lib, self.name)
        fn.argtypes, fn.restype = self.argtypes, self.restype
        return fn

    def __call__(self, *args):
        return self.bind()(*args)

    def launch(self, device, *args, count=None, stream=None, returns=()):
        """Calls the function with ``args`` and the CUDA stream last
        (``stream``, or ``device``'s current one) on ``device``; counts a
        launch of the kernel ``count`` in :data:`LAUNCHES` when it returns
        0.  Another return code raises ``RuntimeError``, but for those in
        ``returns``, which the caller reads itself.  Returns the code."""
        fn = self.bind()
        with torch.cuda.device(device):
            if stream is None:
                stream = torch.cuda.current_stream(device)
            rc = fn(*args, stream.cuda_stream)
        if rc == 0:
            if count is not None:
                LAUNCHES[count] += 1
        elif rc not in returns:
            raise RuntimeError("%s failed with CUDA error %d"
                               % (self.name, rc))
        return rc


class StructFn(Fn):
    """A kernel ``name(const Args*, ..., stream)`` of ``csrc/<lib>.cu``
    that copies its argument struct into the launch's parameters during
    the call, so that nothing of the struct need outlive it; ``extra`` are
    the ctypes of any arguments between the two.  ``layout`` maps the
    library's exports that give the struct's size and constants (C
    functions of no argument that return an int) to the values the ctypes
    mirror is laid out by; they are checked at first use."""

    def __init__(self, lib, name, layout, extra=()):
        super().__init__(lib, name, [ctypes.c_void_p, *extra,
                                     ctypes.c_void_p])
        self.layout = layout

    def layout_of(self, lib=None):
        """The values of the layout's exports in ``lib`` (the built
        library by default)."""
        return {n: Fn(self.lib, n, []).bind(lib)() for n in self.layout}

    def bind(self, lib=None):
        if lib is None and self._fn is None:
            got = self.layout_of()
            if got != self.layout:
                raise RuntimeError("%s's argument layout is %s in the "
                                   "kernel, %s here"
                                   % (self.name, got, self.layout))
        return super().bind(lib)

    def launch_all(self, device, structs, count):
        """One launch for each struct of ``structs``, counted as
        ``count``."""
        for a in structs:
            self.launch(device, ctypes.addressof(a), count=count)
