"""Device detection and the environment record for results.

Counterpart of ``tpul2/utils/platform.py``: the reference keys its kernels by GPU
(``h100``) and reads the device at build time.  ``device_info`` is what every result of
the port carries, so that a number is never read without the card and power limit it was
taken on.
"""

from __future__ import annotations

import importlib.util
import shutil
import subprocess

import torch

#: Capability of the card the kernels are built for (``sm_90a``).
HOPPER_CAPABILITY = (9, 0)


def gen() -> str:
    """Device key of the port (the role of ``tpu_generation``)."""
    return "h100"


def _run(cmd: list) -> str | None:
    if shutil.which(cmd[0]) is None:
        return None
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=30, check=True)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired, OSError):
        return None
    return out.stdout.strip() or None


def nvcc_path() -> str | None:
    """``nvcc`` on PATH, else the toolkit's default location, else None."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    return default if shutil.which(default) else None


def nvidia_smi_name_power() -> str | None:
    """``name, power.limit`` of the first card, exactly as nvidia-smi prints it."""
    out = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    return out.splitlines()[0].strip() if out else None


def device_info() -> dict:
    """Name, capability, count, CUDA and nvcc versions, and nvidia-smi's name/power line."""
    nvcc = nvcc_path()
    nvcc_version = _run([nvcc, "--version"]) if nvcc else None
    info = {
        "gen": gen(),
        "cuda_available": torch.cuda.is_available(),
        "count": torch.cuda.device_count() if torch.cuda.is_available() else 0,
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvcc": nvcc_version.splitlines()[-1] if nvcc_version else None,
        "triton_importable": importlib.util.find_spec("triton") is not None,
        "nvidia_smi": nvidia_smi_name_power(),
    }
    if info["cuda_available"]:
        info["name"] = torch.cuda.get_device_name(0)
        info["capability"] = list(torch.cuda.get_device_capability(0))
    else:
        info["name"] = "cpu"
        info["capability"] = None
    return info


def device_name(device: str) -> str:
    """The name a result records for ``device``: the card's name, or 'cpu'."""
    return torch.cuda.get_device_name(0) if device == "cuda" else "cpu"


def check_device(device: str, what: str) -> None:
    """Raise unless ``device`` is 'cuda' with a card present, or 'cpu' (asked for)."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device: {what}; pass device='cpu' (--device cpu) to "
                           "run the plain versions on the host clock")


def require_hopper() -> None:
    """Raise unless a CUDA card of capability 9.0 is present."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the tpul2_torch kernels need an H100 (sm_90a)")
    cap = torch.cuda.get_device_capability(0)
    if tuple(cap) != HOPPER_CAPABILITY:
        raise RuntimeError(f"device capability {cap} is not Hopper {HOPPER_CAPABILITY}; "
                           "the kernels are built for sm_90a only")
