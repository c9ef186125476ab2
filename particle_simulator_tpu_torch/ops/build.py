"""Build and load the port's CUDA kernels (``ops/csrc/*.cu``).

``nvcc`` compiles every ``.cu`` file under ``csrc/`` for Hopper (``sm_90a``)
into one shared library with a plain C interface,
``particle_simulator_tpu_torch/build/libps_kernels.so``, which is loaded with
``ctypes``. The build runs at first use and again only when the sources or
flags change (a SHA-256 of both is stamped beside the library). The files
compile in parallel, one ``nvcc`` each, and link once. Fast math is never
on: the step kernels need full-precision ``logf``/``expf``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
LIB_NAME = "libps_kernels.so"
BUILD_LOG = "build.log"  # what nvcc and ptxas said, beside the library
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel, in BUILD_LOG
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# entry point -> argtypes (pointers and the stream as c_void_p, so ctypes
# never truncates them to 32 bits); every entry point returns a cudaError_t
_SIGNATURES = {
    # x, y, vx, vy, ty, params, ox, oy, ovx, ovy, n_grids, gy, gx, cap, ring, stream
    "ps_bucket_step": [_P] * 10 + [_I] * 5 + [_P],
    # x, y, vx, vy, ty, params, flags, order, sizes, ox, oy, ovx, ovy,
    # gy, gx, cap, ty_rows, n_chunks, compact, block_budget, stream
    "ps_bucket_step_tiles": [_P] * 13 + [_I] * 7 + [_P],
    # x, y, ty, offsets, destid, n_grids, gy, gx, cap, bx_log2, by_log2, ring, stream
    "ps_bucket_dest": [_P] * 5 + [_I] * 7 + [_P],
    # x, y, vx, vy, ty, destid, ox, oy, ovx, ovy, oty, n_grids, n_src, n_out, stream
    "ps_bucket_place": [_P] * 11 + [_I, ctypes.c_long, ctypes.c_long, _P],
    # x, y, vx, vy, ty, params, ox, oy, ovx, ovy, n, stream
    "ps_allpairs_step": [_P] * 10 + [_I, _P],
    # pairs per iteration of the all-pairs kernel's main loop
    "ps_allpairs_pairs_per_iter": [],
    # the segment length of the all-pairs sum the library was built with
    "ps_allpairs_segment": [],
    # pairs per iteration of the tile-scheduled step's candidate run loop
    "ps_bucket_tiles_pairs_per_iter": [],
}


class KernelBuildError(RuntimeError):
    """The kernels cannot be built here: no nvcc, or nvcc failed."""


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def find_nvcc() -> str:
    """``nvcc`` from PATH, then ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise KernelBuildError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels build only where the CUDA toolkit is installed; CPU tensors "
        "use the plain PyTorch versions and need no build"
    )


def build() -> Path:
    """Compile the kernels if the stamped hash is stale; return the library."""
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = source_hash()
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [BUILD_DIR / f".{src.stem}.{tag}.o" for src in sources()]
    tmp = BUILD_DIR / f".{LIB_NAME}.{tag}"
    try:
        # one nvcc per source, all at once, then one link
        procs = [
            (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                   text=True))
            for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                        for src, obj in zip(sources(), objs))
        ]
        steps = [(cmd, proc.communicate()[1], proc.returncode) for cmd, proc in procs]
        if all(rc == 0 for _, _, rc in steps):
            cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            steps.append((cmd, proc.stderr, proc.returncode))
        for cmd, err, rc in steps:
            if rc != 0:
                raise KernelBuildError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{err}")
        os.replace(tmp, lib)
        log = "".join(f"$ {' '.join(cmd)}\n{err}" for cmd, err, _ in steps)
        (BUILD_DIR / BUILD_LOG).write_text(log)
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    stamp.write_text(digest)
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
