"""tpul2_torch.native: the g++-built tuning cache and its binary file.

Counterpart of tests/test_native.py.  The library is the real one, built with g++ at first
use into tpul2_torch/_build/ (no card, no nvcc needed); a build that fails raises.  The
cache stands alone: dispatch answers from the JSON DB and needs no compiler.
"""

import json
import struct
import subprocess

import pytest

from tpul2_torch import dispatch
from tpul2_torch.autotune import db as db_mod
from tpul2_torch.config import KernelConfig
from tpul2_torch.native import NativeTuneCache, build
from tpul2_torch.native.gen_constants import vendor_table_crc
from tpul2_torch.ops.baselines import VENDOR_VARIANTS

MAGIC, VERSION = 0x48324C54, 1
#: struct.pack format of one (TL2Key, TL2Config) pair: 5 + 8 int32, then the float tflops.
PAIR = "<5i8if"


def test_put_get_roundtrip():
    nc = NativeTuneCache()
    cfg = KernelConfig(bm=32, bn=128, bk=512, acc_dtype="bfloat16", grid_order="nm")
    nc.put(64, 128, 256, cfg, acc="bfloat16", tflops=42.0)
    assert len(nc) == 1
    assert nc.get(64, 128, 256, acc="bfloat16") == cfg
    assert nc.get(64, 128, 256, acc="float32") is None
    assert nc.get(65, 128, 256, acc="bfloat16") is None
    assert nc.get(64, 128, 256, acc="bfloat16", in_dtype="float32") is None


def test_every_field_roundtrips():
    """Every KernelConfig field survives the packed layout (the JAX test's v2 fields:
    the layout bit; here also the edge, the stage depth and the raster)."""
    nc = NativeTuneCache()
    cfgs = [KernelConfig(bm=64, bn=64, bk=64, rhs_layout="nk", pipeline_depth=4),
            KernelConfig(bm=128, bn=32, bk=1024, edge="mask", grid_order="nm",
                         acc_dtype="bfloat16"),
            KernelConfig(bm=128, bn=128, bk=16384, pipeline_depth=8, rhs_layout="nk",
                         grid_order="nm")]
    for i, cfg in enumerate(cfgs):
        nc.put(64 + i, 4096, 512, cfg, acc=cfg.acc_dtype)
    for i, cfg in enumerate(cfgs):
        assert nc.get(64 + i, 4096, 512, acc=cfg.acc_dtype) == cfg


def test_vendor_sentinel_roundtrip():
    """Every vendor variant id, and the header's id table is VENDOR_VARIANTS'."""
    nc = NativeTuneCache()
    for i, v in enumerate(VENDOR_VARIANTS):
        nc.put(8 + i, 8, 8, KernelConfig.vendor(v))
    for i, v in enumerate(VENDOR_VARIANTS):
        got = nc.get(8 + i, 8, 8)
        assert got == KernelConfig.vendor(v), (v, got)
    lib = build.load_native()
    assert [lib.tl2_vendor_variant(i).decode() for i in range(len(VENDOR_VARIANTS))] == \
        list(VENDOR_VARIANTS)
    assert lib.tl2_vendor_variant(len(VENDOR_VARIANTS)) is None
    with pytest.raises(ValueError):
        nc.put(1, 1, 1, KernelConfig.vendor("cublaslt_autotuned_nn"))  # not a sentinel


def test_put_overwrites():
    nc = NativeTuneCache()
    nc.put(256, 256, 256, KernelConfig(bm=64, bn=64, bk=128), tflops=1.0)
    nc.put(256, 256, 256, KernelConfig.vendor("cublas_tn"), tflops=2.0)
    assert len(nc) == 1
    assert nc.get(256, 256, 256) == KernelConfig.vendor("cublas_tn")


def test_grows_past_its_first_capacity():
    """The table starts at 1024 slots and grows at 70% load: 3000 keys all come back."""
    nc = NativeTuneCache()
    keys = [(8 * (i + 1), 64 * (i % 7 + 1), 128 * (i % 5 + 1)) for i in range(3000)]
    for i, (m, n, k) in enumerate(keys):
        nc.put(m, n, k, KernelConfig(bm=64, bn=64, bk=128, pipeline_depth=i % 9))
    assert len(nc) == len(keys)
    for i, (m, n, k) in enumerate(keys):
        assert nc.get(m, n, k).pipeline_depth == i % 9


def test_persistence(tmp_path):
    nc = NativeTuneCache()
    for i, m in enumerate((64, 128, 256)):
        nc.put(m, m, m, KernelConfig(bm=64, bn=128, bk=128), tflops=float(i))
    nc.save(tmp_path / "cache.bin")
    back = NativeTuneCache().load(tmp_path / "cache.bin")
    assert len(back) == 3
    assert back.get(128, 128, 128) == KernelConfig(bm=64, bn=128, bk=128)


def test_committed_db_roundtrips_through_a_file(tmp_path):
    """The committed H100 DB's entries, put into the cache, saved and loaded back, answer
    every exact key as the JSON does."""
    entries = json.loads((db_mod._DATA_DIR / "tunedb_h100.json").read_text())["entries"]
    nc = NativeTuneCache()
    keys = {}
    for key, e in entries.items():
        mnk, acc, dt = key.split("/")
        m, n, k = (int(x) for x in mnk.split("_"))
        keys[(m, n, k, acc, dt)] = KernelConfig(**e["config"])
        nc.put(m, n, k, keys[(m, n, k, acc, dt)], acc=acc, in_dtype=dt,
               tflops=e.get("tflops", 0.0))
    nc.save(tmp_path / "tunedb_h100.bin")
    back = NativeTuneCache().load(tmp_path / "tunedb_h100.bin")
    assert len(back) == len(entries) > 0
    for (m, n, k, acc, dt), cfg in keys.items():
        assert back.get(m, n, k, acc, dt) == cfg, (m, n, k, acc, dt)


def _pair(vendor_variant: int) -> bytes:
    return struct.pack(PAIR, 64, 64, 64, 0, 0, 64, 64, 64, 0, 0, 0, 0, vendor_variant, 1.0)


@pytest.mark.parametrize("case", [
    ("magic", struct.pack("<IIII", 0x54503255, VERSION, vendor_table_crc(), 0)),  # JAX's
    ("version", struct.pack("<IIII", MAGIC, VERSION + 1, vendor_table_crc(), 0)),
    ("vendor table", struct.pack("<IIII", MAGIC, VERSION, vendor_table_crc() ^ 1, 0)),
    ("truncated", struct.pack("<IIII", MAGIC, VERSION, vendor_table_crc(), 2) + _pair(0)),
    ("vendor id out of range", struct.pack("<IIII", MAGIC, VERSION, vendor_table_crc(), 1)
     + _pair(len(VENDOR_VARIANTS))),
], ids=lambda c: c[0])
def test_foreign_file_rejected(tmp_path, case):
    """A file of another magic, layout version or vendor id table, a truncated one, or one
    with an entry out of range is refused, not misread."""
    p = tmp_path / "old.bin"
    p.write_bytes(case[1])
    with pytest.raises(OSError):
        NativeTuneCache().load(p)


def test_the_file_layout_is_the_documented_one(tmp_path):
    """A file packed by hand in the documented layout (header, then key/config pairs) loads:
    the rejections above are of the cases, not of every hand-made file."""
    p = tmp_path / "hand.bin"
    p.write_bytes(struct.pack("<IIII", MAGIC, VERSION, vendor_table_crc(), 1) + _pair(2))
    nc = NativeTuneCache().load(p)
    assert nc.get(64, 64, 64) == KernelConfig(bm=64, bn=64, bk=64,
                                              vendor_variant=VENDOR_VARIANTS[2])


def test_missing_file_rejected(tmp_path):
    with pytest.raises(OSError):
        NativeTuneCache().load(tmp_path / "absent.bin")


def test_standalone_binary_selftest(tmp_path):
    """The gated main() builds (without -DNO_TL2_BIN) and passes."""
    exe = build.build_selftest(tmp_path / "tunecache_selftest")
    out = subprocess.run([str(exe), str(tmp_path / "selftest.bin")], capture_output=True,
                         text=True, check=True, cwd=tmp_path, timeout=60)
    assert "PASS" in out.stdout, out.stdout
    assert all(v in out.stdout for v in VENDOR_VARIANTS)


@pytest.fixture
def no_compiler(monkeypatch):
    """A C++ compiler that cannot run, with no library loaded in this process."""
    monkeypatch.setattr(build, "CXX", "/nonexistent/g++")
    build.load_native.cache_clear()
    yield
    monkeypatch.undo()
    build.load_native.cache_clear()


def test_build_failure_raises(no_compiler):
    """A compiler that cannot run raises: there is no silent pure-Python path."""
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        NativeTuneCache()


def test_dispatch_needs_no_compiler(no_compiler, tmp_path, monkeypatch):
    """resolve_config answers from the JSON DB, so a host without a C++ compiler still
    dispatches: an exact entry, and the heuristic where the DB has none."""
    path = tmp_path / "db.json"
    db = db_mod.TuneDB(path=path)
    cfg = KernelConfig(bm=128, bn=64, bk=512, rhs_layout="nk")
    db.put(1024, 1024, 1024, cfg, tflops=150.0)
    db.save()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["db.json"]
    monkeypatch.setenv(db_mod.ENV_VAR, str(path))
    db_mod.reset_default_db()
    try:
        assert dispatch.resolve_config(1024, 1024, 1024) == cfg
        assert dispatch.resolve_config(512, 512, 512, "bfloat16") == \
            dispatch.heuristic_config(512, 512, 512, "bfloat16")
    finally:
        db_mod.reset_default_db()
