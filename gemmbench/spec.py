"""Find a cell's workload, its configuration and the metric readers by name.

``workloads/<cell>.json`` holds the traffic's parameters, the call it drives, the check's
limits and the end-to-end metrics the cell reports; ``configs/<config>.json`` the sizes;
``metrics/<metric>.py`` one reader each.  A later cell or metric is a file added here,
with no code edited.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _file(root: Path, folder: str, name: str, suffix: str) -> Path:
    if not NAME.fullmatch(name):
        raise ValueError(f"not a name: {name!r}")
    path = root / folder / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder[:-1]} named {name!r} ({path})")
    return path


def workload(name: str, root: Path = ROOT) -> dict:
    """The cell's workload, with its configuration under ``"config_spec"``."""
    spec = json.loads(_file(root, "workloads", name, ".json").read_text())
    spec["name"] = name
    spec["config_spec"] = json.loads(_file(root, "configs", spec["config"], ".json").read_text())
    return spec


def workload_names(root: Path = ROOT) -> list:
    return sorted(p.stem for p in (root / "workloads").glob("*.json"))


def readers(root: Path = ROOT) -> dict:
    """{metric name: its reader module} of every file under ``metrics/``."""
    out = {}
    for path in sorted((root / "metrics").glob("*.py")):
        name = path.name[:-3]
        mod_spec = importlib.util.spec_from_file_location(
            "gemmbench_metric_" + name.replace(".", "_"), path)
        module = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(module)
        out[name] = module
    return out


def cell_readers(spec: dict, trace: bool, root: Path = ROOT) -> dict:
    """The readers a run of the cell reports: with trace off its end-to-end metrics
    (``setup_s`` and the workload's ``end_to_end``), with trace on every per-layer metric
    that moves one of them."""
    e2e = ["setup_s", *spec["end_to_end"]]
    found = readers(root)
    if not trace:
        return {name: found[name] for name in e2e}
    return {name: r for name, r in found.items()
            if r.KIND == "per_layer" and r.MOVES in e2e}
