"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for sm_90a into a shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch headers,
so a build takes seconds). Libraries go to ``<repo>/build/torch_kernels/``
(or the directory given to :func:`set_build_dir`, the CLI's ``--cache_dir``),
named by a hash of the source and flags, and are built at first use in the
process that needs them (or all at once, in parallel, by :func:`build`); the
first load of any of a run's libraries (:data:`RUN_LIBRARIES`) builds all of
them together, so a checkout's first run waits for the slowest nvcc, not for
the sum. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
DEFAULT_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
BUILD_DIR = DEFAULT_BUILD_DIR

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# the kernel libraries a synthesis run loads (codec, transport), built
# together; also built before ranks are started so that the ranks only load
RUN_LIBRARIES = ("codec", "cdf", "conv_wg", "edge_mma", "rotgemm")

_LIBS = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "(the CUDA kernels build on the machine with the GPU)")


def set_build_dir(path: str) -> None:
    """Build the kernel libraries into ``path`` ('' = the default,
    ``build/torch_kernels/`` in the repository); libraries this process has
    loaded already stay loaded."""
    global BUILD_DIR
    BUILD_DIR = os.path.abspath(path) if path else DEFAULT_BUILD_DIR


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to (the name hashes source + flags)."""
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build(*names: str) -> List[str]:
    """Compile each ``csrc/<name>.cu`` whose library does not exist yet, one
    nvcc process per source, all started together; return the libraries'
    paths. A failed compile raises after every process has ended.

    The compiler's output (``-Xptxas -v``: registers, shared memory, spills
    per kernel) is kept beside each library as ``<library>.log``."""
    outs = [library_path(n) for n in names]
    todo = [(n, o) for n, o in zip(names, outs) if not os.path.exists(o)]
    if todo:
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = nvcc_path()
        procs = []
        for name, out in todo:
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC_DIR, name + ".cu")]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for name, out, tmp, proc in procs:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed on csrc/{name}.cu (exit "
                              f"{proc.returncode}):\n{stderr}{stdout}")
                continue
            with open(out + ".log", "w") as f:
                f.write(stderr + stdout)
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))
    return outs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use (with
    the rest of :data:`RUN_LIBRARIES` when it is one of them)."""
    with _LOCK:
        if name not in _LIBS:
            names = RUN_LIBRARIES if name in RUN_LIBRARIES else (name,)
            _LIBS[name] = ctypes.CDLL(build(*names)[names.index(name)])
        return _LIBS[name]
