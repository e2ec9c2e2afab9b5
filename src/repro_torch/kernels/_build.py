"""Build the CUDA sources under ``repro_torch/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is compiled
with ``nvcc`` for ``sm_90a`` into ``<repo>/build/kernels/lib<name>-<hash>.so``
(the hash is of the source and the flags, so an edited source is rebuilt)
and loaded with :mod:`ctypes`. Nothing here runs at import time, so the
module imports on a machine without ``nvcc`` or a GPU.

It also keeps the launches by mesh position (:func:`tally`) and the hooks
through which the wrappers and the mesh's copies report to the dry-run's
cost counter (:func:`count_kernel`, :func:`count_moved`, :class:`uncounted`).
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
#: ``<repo>/build/kernels`` — listed in ``.gitignore``
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# --split-compile=0 runs the optimizer on every core, one kernel a thread:
# flash_attention.cu's eleven kernels build in 13.9 s instead of 25.7 s on
# the H100 machine, with the same registers for each
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    "--split-compile=0",
)
SOURCES = ("similarity", "aggregate", "sketch", "flash_attention")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}  # name -> library, one load per process

#: Launches by (kernel, mesh position) of the work run as a mesh position
#: (``repro_torch.launch.mesh.on_shard``); a wrapper adds to it where it
#: adds to its own count. The position is the process's, not a thread's:
#: a backward pass runs on autograd's device threads while the thread that
#: asked for it waits.
shard_launches: collections.Counter = collections.Counter()
_shard = [None]  # the mesh position whose work is running, if any


def set_shard(shard):
    """Make ``shard`` (an int, or None) the running mesh position; returns
    the previous one."""
    prev, _shard[0] = _shard[0], shard
    return prev


def tally(kernel: str) -> None:
    """Count one launch of ``kernel`` under the running mesh position."""
    if _shard[0] is not None:
        shard_launches[(kernel, _shard[0])] += 1


def current_shard():
    """The running mesh position, or None."""
    return _shard[0]


#: The cost counter that is counting, if any
#: (``repro_torch.launch.roofline.CostCounter``): the wrappers report each
#: call's work to it and the mesh's copies the bytes they move.
_counter = [None]


def set_counter(counter):
    """Make ``counter`` (or None) the one counting; returns the previous one."""
    prev, _counter[0] = _counter[0], counter
    return prev


def counting() -> bool:
    """Whether a cost counter is counting."""
    return _counter[0] is not None


def count_kernel(kernel: str, flops: float, nbytes: float, like) -> None:
    """Add one call of ``kernel`` doing ``flops`` operations over
    ``nbytes`` bytes, at the position of the tensor ``like``, to the
    running count (a wrapper calls it once a call, whichever route runs)."""
    if _counter[0] is not None:
        _counter[0].kernel(kernel, flops, nbytes, like)


def count_moved(kind: str, src, dst: int, nbytes: int) -> None:
    """Add ``nbytes`` copied from mesh position ``src`` (an int, or a
    tensor standing for the position that holds it) to ``dst`` under the
    collective ``kind`` to the running count; a copy within a position
    moves nothing."""
    if _counter[0] is not None:
        _counter[0].moved(kind, src, int(dst), int(nbytes))


class uncounted:
    """Leave the enclosed torch ops out of the running count: a wrapper's
    plain version, whose work the wrapper has counted by its formula."""

    def __enter__(self):
        self._counter = _counter[0]
        if self._counter is not None:
            self._counter.paused += 1
        return self

    def __exit__(self, *exc):
        if self._counter is not None:
            self._counter.paused -= 1


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin")
    return found


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return src, BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile the named sources that are not built yet, all ``nvcc`` in parallel.

    Returns ``{name: compiler output}`` (``-Xptxas -v`` register and
    shared-memory report) for the sources it compiled. Raises on any
    compiler error.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        src, lib = _target(name)
        if lib.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
            lib,
        )
    logs, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The ctypes library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(_target(name)[1]))
            _loaded[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point of ``lib`` returned a non-zero ``cudaError_t``."""
    if err != 0:
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")
