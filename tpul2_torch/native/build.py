"""Build and bind the native tuning cache: g++ into a shared library, loaded with ctypes.

Counterpart of ``tpul2/native/build.py``.  At first use ``tunecache.cc`` is compiled
with g++ (host code only: no nvcc, no CUDA headers) into
``tpul2_torch/_build/libtl2_native.so``, beside the header that ``gen_constants``
renders from ``tpul2_torch.ops.baselines``; a sha256 stamp of the compiler, the flags, the
source and the rendered header triggers a rebuild whenever one of them changes, as
``ops/_build.py`` does for the kernels.

A build that fails raises, with the compiler's output.  The JAX module falls back to
pure Python when its build fails, which hides whether the native layer runs at all; this
one has no such path.  Nothing in dispatch imports this module, so a host without a C++
compiler still resolves configs and launches kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Optional

from tpul2_torch.config import KernelConfig
from tpul2_torch.native import gen_constants
from tpul2_torch.ops.baselines import VENDOR_VARIANTS

_DIR = Path(__file__).resolve().parent
SOURCE = _DIR / "tunecache.cc"
BUILD_DIR = _DIR.parent / "_build"
HEADER = BUILD_DIR / "tl2_native_constants.h"
LIB_PATH = BUILD_DIR / "libtl2_native.so"
#: The C++ compiler; g++ is on both the CPU test machine and the card's.
CXX = "g++"
CXXFLAGS = ["-O3", "-std=c++17", "-Wall", "-Wextra", "-fPIC"]

_ACC_IDS = {"float32": 0, "bfloat16": 1}
_ORDER_IDS = {"mn": 0, "nm": 1}
_DTYPE_IDS = {"bfloat16": 0, "float32": 1, "float16": 2}
_VENDOR, _RHS_NK, _EDGE_MASK = 1, 2, 4


class TL2Config(ctypes.Structure):
    # struct TL2Config of tunecache.cc (layout version 1)
    _fields_ = [("bm", ctypes.c_int32), ("bn", ctypes.c_int32), ("bk", ctypes.c_int32),
                ("acc", ctypes.c_int32), ("grid_order", ctypes.c_int32),
                ("pipeline_depth", ctypes.c_int32), ("flags", ctypes.c_int32),
                ("vendor_variant", ctypes.c_int32), ("tflops", ctypes.c_float)]


class TL2Key(ctypes.Structure):
    _fields_ = [("m", ctypes.c_int32), ("n", ctypes.c_int32), ("k", ctypes.c_int32),
                ("acc", ctypes.c_int32), ("dtype", ctypes.c_int32)]


def _compile(out: Path, extra: list) -> str:
    """Compile tunecache.cc against the freshly rendered header into ``out``; return the
    compiler's output.  Raises RuntimeError if the compiler is missing or fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp_header = HEADER.with_suffix(f".h.tmp{os.getpid()}")
    tmp_header.write_text(gen_constants.render())
    os.replace(tmp_header, HEADER)
    cmd = [CXX, *CXXFLAGS, *extra, "-I", str(BUILD_DIR), "-o", str(out), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"cannot run the C++ compiler {CXX!r} to build the native "
                           f"tuning cache: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def _digest() -> str:
    h = hashlib.sha256(" ".join([CXX, *CXXFLAGS]).encode())
    h.update(SOURCE.read_bytes())
    h.update(gen_constants.render().encode())
    return h.hexdigest()


def _bind(lib: ctypes.CDLL) -> None:
    p, pk, pc = ctypes.c_void_p, ctypes.POINTER(TL2Key), ctypes.POINTER(TL2Config)
    sigs = {"tl2_cache_new": ([], p), "tl2_cache_free": ([p], None),
            "tl2_cache_size": ([p], ctypes.c_uint64),
            "tl2_cache_put": ([p, pk, pc], ctypes.c_int32),
            "tl2_cache_get": ([p, pk, pc], ctypes.c_int32),
            "tl2_cache_save": ([p, ctypes.c_char_p], ctypes.c_int32),
            "tl2_cache_load": ([p, ctypes.c_char_p], ctypes.c_int32),
            "tl2_vendor_variant": ([ctypes.c_int32], ctypes.c_char_p)}
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype


@functools.cache
def load_native() -> ctypes.CDLL:
    """The native library, built first if it is missing or stale.  Raises on failure.

    ``lib.build_seconds`` is this process's build time (0.0 when a current library was
    loaded)."""
    digest = _digest()
    stamp = LIB_PATH.with_suffix(".sha256")
    seconds = 0.0
    if not (LIB_PATH.exists() and stamp.exists() and stamp.read_text() == digest):
        tmp = LIB_PATH.with_suffix(f".so.tmp{os.getpid()}")
        t0 = time.perf_counter()
        _compile(tmp, ["-shared", "-DNO_TL2_BIN"])
        seconds = time.perf_counter() - t0
        os.replace(tmp, LIB_PATH)
        stamp.write_text(digest)
    lib = ctypes.CDLL(str(LIB_PATH))
    _bind(lib)
    lib.build_seconds = seconds
    return lib


def build_selftest(out: Path) -> Path:
    """Compile the standalone self-test binary (tunecache.cc's main()) into ``out``."""
    _compile(Path(out), [])
    return Path(out)


def _pack(cfg: KernelConfig, tflops: float) -> TL2Config:
    flags = ((_VENDOR if cfg.use_vendor else 0) | (_RHS_NK if cfg.rhs_layout == "nk" else 0)
             | (_EDGE_MASK if cfg.edge == "mask" else 0))
    try:
        return TL2Config(cfg.bm, cfg.bn, cfg.bk, _ACC_IDS[cfg.acc_dtype],
                         _ORDER_IDS[cfg.grid_order], cfg.pipeline_depth, flags,
                         VENDOR_VARIANTS.index(cfg.vendor_variant), tflops)
    except (KeyError, ValueError) as e:
        raise ValueError(f"the native cache cannot hold {cfg}: {e}") from e


def _unpack(c: TL2Config) -> KernelConfig:
    return KernelConfig(
        bm=c.bm, bn=c.bn, bk=c.bk, acc_dtype="float32" if c.acc == 0 else "bfloat16",
        grid_order="mn" if c.grid_order == 0 else "nm",
        rhs_layout="nk" if c.flags & _RHS_NK else "kn",
        edge="mask" if c.flags & _EDGE_MASK else "pad", pipeline_depth=c.pipeline_depth,
        use_vendor=bool(c.flags & _VENDOR), vendor_variant=VENDOR_VARIANTS[c.vendor_variant])


def _key(m: int, n: int, k: int, acc: str, in_dtype: str) -> TL2Key:
    return TL2Key(m, n, k, _ACC_IDS[acc], _DTYPE_IDS[in_dtype])


class NativeTuneCache:
    """ctypes wrapper over the C++ open-addressing cache: (m, n, k, acc, in_dtype name) ->
    KernelConfig."""

    def __init__(self):
        self._lib = load_native()
        self._h = ctypes.c_void_p(self._lib.tl2_cache_new())

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.tl2_cache_free(self._h)
            self._h = None

    def __len__(self) -> int:
        return int(self._lib.tl2_cache_size(self._h))

    def put(self, m: int, n: int, k: int, config: KernelConfig, acc: str = "float32",
            in_dtype: str = "bfloat16", tflops: float = 0.0) -> None:
        cfg = _pack(config, tflops)
        if self._lib.tl2_cache_put(self._h, ctypes.byref(_key(m, n, k, acc, in_dtype)),
                                   ctypes.byref(cfg)) != 0:
            raise ValueError(f"tl2_cache_put refused {config}")

    def get(self, m: int, n: int, k: int, acc: str = "float32",
            in_dtype: str = "bfloat16") -> Optional[KernelConfig]:
        out = TL2Config()
        if self._lib.tl2_cache_get(self._h, ctypes.byref(_key(m, n, k, acc, in_dtype)),
                                   ctypes.byref(out)):
            return _unpack(out)
        return None

    def save(self, path) -> None:
        """Write the entries to a binary file."""
        rc = self._lib.tl2_cache_save(self._h, str(path).encode())
        if rc != 0:
            raise OSError(f"tl2_cache_save({path}) failed: {rc}")

    def load(self, path) -> "NativeTuneCache":
        """Add a file's entries.  Raises OSError for a missing file, another magic or
        layout version, another vendor id table, or an entry out of range."""
        rc = self._lib.tl2_cache_load(self._h, str(path).encode())
        if rc != 0:
            raise OSError(f"tl2_cache_load({path}) failed: {rc}")
        return self
