"""Build and load the CUDA kernels: nvcc into a shared library with a plain C interface.

The role of ``tpul2/native/build.py``.  Every ``csrc/*.cu`` of the package is compiled
for ``sm_90a`` into an object of its own (the ring kernel's instances are spread over four
files that share ``csrc/tl2_wgmma.cuh``, the wide route's over ten more that share
``csrc/tl2_wgmma_wide.cuh``), all nvcc processes started together, then linked into
``tpul2_torch/_build/libtl2_kernels.so`` at first use (with the toolkit's cuBLASLt,
``LINK_FLAGS``, for the auto-tuning baseline's search) and loaded with ctypes.  The build is redone whenever a source or the flags change (a sha256
stamp beside the library).  Only sources in the repository are compiled; nothing is fetched.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path

from tpul2_torch.utils.platform import nvcc_path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_PATH = BUILD_DIR / "libtl2_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
#: csrc/tl2_lt_autotune.cu calls cuBLASLt (host code only; the card's toolkit has it).
LINK_FLAGS = ["-lcublasLt"]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: C signature of each tl2_matmul and tl2_wgmma launcher: a, b, bias, c, batch, m, n, k,
#: sa, sb, sc, bm, bn, bk, rhs_nk, acc_bf16, act, raster_nm, vec_a, vec_b, stream.
#: tl2_matmul and tl2_staged (mma.sync) are on no route: only chip_smoke.py launches them.
_LAUNCH_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL, _LL, _I, _I, _I,
                    _I, _I, _I, _I, _I, _I, _P]
#: C signature of tl2_staged: a, b, c, m, n, k, bm, bn, depth, rhs_nk, raster_nm, out_f32,
#: stream.
_STAGED_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]
#: C signature of tl2_wgmma_staged: a, b, c, ws, m, n, k, bm, bn, depth, splits, rhs_nk,
#: raster_nm, out_f32, stream.
_RING_STAGED_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]
#: The cuBLASLt search's shape key: m, n, k, rhs_nk, out_f32.
_LT_KEY = [_I, _I, _I, _I, _I]

#: cudaError_t codes of a launch refused before any work runs: invalid value (a shape,
#: tile or alignment the launcher does not take, or more dynamic shared memory than the
#: attribute allows), too many resources requested, invalid configuration.
REFUSED_CODES = (1, 7, 9)


class LaunchRefused(RuntimeError):
    """The launcher refused the launch before any work ran (see REFUSED_CODES)."""


def check_launch(err: int, what: str) -> None:
    """Raise if a launcher returned a cudaError_t other than 0."""
    if err == 0:
        return
    cls = LaunchRefused if err in REFUSED_CODES else RuntimeError
    raise cls(f"{what} launch failed: cudaError {err}")


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources: list) -> str:
    """sha256 of the flags, the sources and the headers they include (``csrc/*.cuh``)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def _run_all(cmds: list) -> str:
    """Run the commands side by side; return their joined output, raise if one failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for cmd in cmds]
    logs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} ({proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return "".join(logs)


def _compile(sources: list, digest: str) -> tuple:
    """Run nvcc; return (seconds, nvcc's output with the ptxas register report)."""
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): cannot build "
                           "the tpul2_torch kernels")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    tmp = LIB_PATH.with_suffix(f".so.tmp{tag}")
    t0 = time.perf_counter()
    log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(sources, objs)])
    log += _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs), *LINK_FLAGS]])
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink()
    os.replace(tmp, LIB_PATH)
    LIB_PATH.with_suffix(".sha256").write_text(digest)
    return seconds, log


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernels' library, built first if it is missing or stale.  Raises on failure.

    ``lib.build_seconds`` and ``lib.build_log`` record this process's build (0.0 and ""
    when a current library was loaded)."""
    sources = _sources()
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    digest = _digest(sources)
    stamp = LIB_PATH.with_suffix(".sha256")
    seconds, log = 0.0, ""
    if not (LIB_PATH.exists() and stamp.exists() and stamp.read_text() == digest):
        seconds, log = _compile(sources, digest)
    lib = ctypes.CDLL(str(LIB_PATH))
    lib.build_seconds, lib.build_log = seconds, log
    for name in ("tl2_matmul_bf16out", "tl2_matmul_f32out", "tl2_wgmma_bf16out",
                 "tl2_wgmma_f32out"):
        fn = getattr(lib, name)
        fn.argtypes = _LAUNCH_ARGTYPES
        fn.restype = ctypes.c_int
    lib.tl2_staged.argtypes = _STAGED_ARGTYPES
    lib.tl2_staged.restype = ctypes.c_int
    lib.tl2_wgmma_staged.argtypes = _RING_STAGED_ARGTYPES
    lib.tl2_wgmma_staged.restype = ctypes.c_int
    # ws, c, m, n, splits, out_f32, stream
    lib.tl2_splitk_reduce.argtypes = [_P, _P, _I, _I, _I, _I, _P]
    lib.tl2_splitk_reduce.restype = ctypes.c_int
    lib.tl2_wgmma_smem_bytes.argtypes = [_I, _I, _I]
    lib.tl2_wgmma_smem_bytes.restype = ctypes.c_int
    lib.tl2_wgmma_carry_stages.argtypes = [_I, _I]
    lib.tl2_wgmma_carry_stages.restype = ctypes.c_int
    # bm, k, stages, streamed
    lib.tl2_wgmma_wide_smem_bytes.argtypes = [_I, _I, _I, _I]
    lib.tl2_wgmma_wide_smem_bytes.restype = ctypes.c_int
    for name in ("tl2_wgmma_wide_stages", "tl2_wgmma_wide_streamed"):  # bm, k
        getattr(lib, name).argtypes = [_I, _I]
        getattr(lib, name).restype = ctypes.c_int
    # m, n, bm, bn, batch
    lib.tl2_wgmma_wide_ctas.argtypes = [_I, _I, _I, _I, _I]
    lib.tl2_wgmma_wide_ctas.restype = ctypes.c_int
    # a launcher's arguments, then out_f32, depth, ctas (only chip_smoke.py calls it)
    lib.tl2_wgmma_wide_witness.argtypes = _LAUNCH_ARGTYPES + [_I, _I, _I]
    lib.tl2_wgmma_wide_witness.restype = ctypes.c_int
    # m, n, k, bm, bn, bk, rhs_nk, a, b, c (None: a fresh output)
    lib.tl2_wgmma_route.argtypes = [_I, _I, _I, _I, _I, _I, _I, _P, _P, _P]
    lib.tl2_wgmma_route.restype = ctypes.c_int
    # m, n, k, bm, bn, rhs_nk, a, b
    lib.tl2_staged_route.argtypes = [_I, _I, _I, _I, _I, _I, _P, _P]
    lib.tl2_staged_route.restype = ctypes.c_int
    _P_I, _P_F = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)
    # key, ws_bytes, max_algos, *n_algos, *n_skipped
    lib.tl2_lt_prepare.argtypes = _LT_KEY + [_LL, _I, _P_I, _P_I]
    # key, a, b, c, ws, ws_bytes, order, n_order, ms, stream
    lib.tl2_lt_time_round.argtypes = _LT_KEY + [_P, _P, _P, _P, _LL, _P_I, _I, _P_F, _P]
    lib.tl2_lt_select.argtypes = _LT_KEY + [_I]
    lib.tl2_lt_selected.argtypes = _LT_KEY
    # key, algo, a, b, c, ws, ws_bytes, stream
    lib.tl2_lt_matmul.argtypes = _LT_KEY + [_I, _P, _P, _P, _P, _LL, _P]
    for name in ("tl2_lt_prepare", "tl2_lt_time_round", "tl2_lt_select", "tl2_lt_selected",
                 "tl2_lt_matmul"):
        getattr(lib, name).restype = ctypes.c_int
    return lib
