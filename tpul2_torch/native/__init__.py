"""The native tuning cache (C++, g++-built, ctypes-bound): ``tpul2.native``'s counterpart."""

from tpul2_torch.native.build import NativeTuneCache  # noqa: F401
