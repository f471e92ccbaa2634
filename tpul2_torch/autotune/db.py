"""Persistent per-shape tuning database of the H100: (M, N, K, acc, in_dtype) -> config.

Counterpart of ``tpul2/autotune/db.py``, with its key format and JSON layout.  The
default file is ``tpul2_torch/data/tunedb_h100.json``; ``TPUL2_TORCH_TUNEDB`` overrides
it.  The JAX package's ``tunedb_v5e.json`` is TPU data and is never read.  Eager torch has
no trace cache, so the JAX side's epoch counter has no counterpart; ``TuneDB.version``
counts the changes of the entries instead, so that a decision drawn from them (the
entry point's resolved config, ``dispatch.resolve_config``) can be kept until they change.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import threading
from pathlib import Path
from typing import Optional

from tpul2_torch.config import KernelConfig
from tpul2_torch.utils.platform import gen as device_gen

_DATA_DIR = Path(__file__).resolve().parent.parent / "data"
ENV_VAR = "TPUL2_TORCH_TUNEDB"


def _dtype_name(in_dtype) -> str:
    return in_dtype if isinstance(in_dtype, str) else str(in_dtype).removeprefix("torch.")


def _key(m: int, n: int, k: int, acc: str, in_dtype="bfloat16") -> str:
    return f"{m}_{n}_{k}/{acc}/{_dtype_name(in_dtype)}"


class TuneDB:
    """Thread-safe JSON-backed map: shape key -> (config, tflops, extras)."""

    def __init__(self, path: Optional[os.PathLike] = None, gen: Optional[str] = None):
        self.gen = gen or device_gen()
        if path is None:
            path = os.environ.get(ENV_VAR) or _DATA_DIR / f"tunedb_{self.gen}.json"
        self.path = Path(path)
        self._lock = threading.Lock()
        self._entries: dict = {}
        self._loaded = False
        #: (acc, dtype) -> {octave bucket (log2 m, log2 n, log2 k) -> [((m, n, k), entry)]};
        #: rebuilt lazily after any mutation.
        self._octave_index: Optional[dict] = None
        #: Bumped by every load and put: a value read before a decision was drawn from the
        #: entries and equal to the current one means they have not changed since.
        self.version = 0
        #: Decisions drawn from the entries, each stored with the version it was drawn at
        #: (``dispatch.resolve_config``'s memo); an entry whose version is not current is
        #: stale and never served.
        self.memo: dict = {}

    # ---- persistence ----
    def load(self) -> "TuneDB":
        with self._lock:
            if self.path.exists():
                self._entries = json.loads(self.path.read_text()).get("entries", {})
            self._loaded = True
            self._octave_index = None
            self.version += 1
        return self

    def save(self) -> None:
        """Write the whole DB to a temporary file, then replace the old one atomically."""
        with self._lock:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            tmp = self.path.with_suffix(".tmp")
            tmp.write_text(json.dumps({"gen": self.gen, "version": 1,
                                       "entries": self._entries}, indent=1, sort_keys=True))
            tmp.replace(self.path)

    def _ensure(self):
        if not self._loaded:
            self.load()

    # ---- access ----
    def get(self, m: int, n: int, k: int, acc: str = "float32",
            in_dtype="bfloat16") -> Optional[KernelConfig]:
        e = self.get_entry(m, n, k, acc, in_dtype)
        return KernelConfig(**e["config"]) if e else None

    def get_entry(self, m: int, n: int, k: int, acc: str = "float32",
                  in_dtype="bfloat16") -> Optional[dict]:
        self._ensure()
        return self._entries.get(_key(m, n, k, acc, in_dtype))

    def items(self) -> list:
        """All ((m, n, k), acc, entry) triples (every in_dtype)."""
        self._ensure()
        out = []
        for key, entry in self._entries.items():
            mnk, acc, _ = key.split("/")
            out.append((tuple(int(x) for x in mnk.split("_")), acc, entry))
        return out

    def entries_near(self, m: int, n: int, k: int, acc: str = "float32",
                     in_dtype="bfloat16", max_ratio: float = 2.0) -> list:
        """((m, n, k), entry) pairs within ``max_ratio`` of the query on every dimension.

        Entries are bucketed by (floor log2 m, floor log2 n, floor log2 k); a query probes
        the buckets within ceil(log2 max_ratio) octaves, then filters exactly, so a lookup
        costs the buckets' occupancy, not the DB's size."""
        self._ensure()
        with self._lock:
            if self._octave_index is None:
                idx: dict = {}
                for key, entry in self._entries.items():
                    mnk_s, acc_s, dt_s = key.split("/")
                    em, en, ek = (int(x) for x in mnk_s.split("_"))
                    b = (em.bit_length() - 1, en.bit_length() - 1, ek.bit_length() - 1)
                    idx.setdefault((acc_s, dt_s), {}).setdefault(b, []).append(
                        ((em, en, ek), entry))
                self._octave_index = idx
            fam = self._octave_index.get((acc, _dtype_name(in_dtype)), {})
        r = max(1, math.ceil(math.log2(max_ratio)))
        qm, qn, qk = m.bit_length() - 1, n.bit_length() - 1, k.bit_length() - 1
        out = []
        for dm in range(-r, r + 1):
            for dn in range(-r, r + 1):
                for dk in range(-r, r + 1):
                    for (em, en, ek), entry in fam.get((qm + dm, qn + dn, qk + dk), ()):
                        if (max(em, m) / min(em, m) <= max_ratio
                                and max(en, n) / min(en, n) <= max_ratio
                                and max(ek, k) / min(ek, k) <= max_ratio):
                            out.append(((em, en, ek), entry))
        return out

    def entries_for(self, acc: str = "float32", in_dtype="bfloat16") -> list:
        """All ((m, n, k), entry) pairs of one (acc, in_dtype) family."""
        self._ensure()
        suffix = f"/{acc}/{_dtype_name(in_dtype)}"
        return [(tuple(int(x) for x in key.split("/", 1)[0].split("_")), entry)
                for key, entry in self._entries.items() if key.endswith(suffix)]

    def put(self, m: int, n: int, k: int, config: KernelConfig, tflops: float,
            acc: str = "float32", in_dtype="bfloat16", extra: Optional[dict] = None) -> None:
        """Store the shape's (offline) winner.  A ``server`` sub-entry already stored for
        the shape is kept: the two regimes are measured apart and never clobber each
        other."""
        self._ensure()
        entry = {"config": dataclasses.asdict(config), "tflops": float(tflops)}
        if extra:
            entry.update(extra)
        key = _key(m, n, k, acc, in_dtype)
        with self._lock:
            old = self._entries.get(key)
            if old is not None and "server" in old:
                entry["server"] = old["server"]
            self._entries[key] = entry
            self._octave_index = None
            self.version += 1

    def put_server(self, m: int, n: int, k: int, config: KernelConfig,
                   acc: str = "float32", in_dtype="bfloat16",
                   extra: Optional[dict] = None) -> None:
        """Store the shape's server-regime (Poisson-arrival) winner as the ``server``
        sub-entry of its entry, the layout of ``tpul2/autotune/db.py:put_server``.

        ``dispatch.resolve_config(mode='server')`` prefers it; everything else reads the
        entry's own config.  A shape with no entry gets one that holds the server config
        with ``"measured": false`` and ``"scope": "server_only"``, so that no offline
        number is made up for it."""
        self._ensure()
        sub = {"config": dataclasses.asdict(config)}
        if extra:
            sub.update(extra)
        with self._lock:
            entry = self._entries.setdefault(
                _key(m, n, k, acc, in_dtype),
                {"config": dict(sub["config"]), "tflops": 0.0, "measured": False,
                 "scope": "server_only"})
            entry["server"] = sub
            self._octave_index = None
            self.version += 1

    def get_server_entry(self, m: int, n: int, k: int, acc: str = "float32",
                         in_dtype="bfloat16") -> Optional[dict]:
        e = self.get_entry(m, n, k, acc, in_dtype)
        return e.get("server") if e else None

    def __len__(self) -> int:
        self._ensure()
        return len(self._entries)


#: (TPUL2_TORCH_TUNEDB as it was at the load, the loaded DB), or None; one reference, so
#: that a reader sees a matching pair without taking the lock.
_default: Optional[tuple] = None
_default_lock = threading.Lock()


def default_db() -> TuneDB:
    """The process's DB at the default path (``TPUL2_TORCH_TUNEDB`` or the data dir),
    loaded anew when the variable has changed since the last load."""
    global _default
    env = os.environ.get(ENV_VAR)
    current = _default
    if current is not None and current[0] == env:
        return current[1]
    with _default_lock:
        if _default is None or _default[0] != env:
            _default = (env, TuneDB(path=env or None).load())
        return _default[1]


def reset_default_db() -> None:
    """Drop the cached default DB (after the path or the file changed)."""
    global _default
    with _default_lock:
        _default = None
