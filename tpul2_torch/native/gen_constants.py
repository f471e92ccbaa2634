"""Render the native layer's C header from ``tpul2_torch.ops.baselines``.

Counterpart of ``tpul2/native/gen_constants.py``.  The packed config must name the same
vendor variants as ``ops.baselines.VENDOR_VARIANTS``: so their id table is not copied by
hand but rendered from the Python module before every build (``native.build``), and the
build's stamp covers the rendered text.  The header is written into
``tpul2_torch/_build/`` with the library, so no generated file is tracked.

    python -m tpul2_torch.native.gen_constants     # print the header
"""

from __future__ import annotations

import zlib


def vendor_table_crc() -> int:
    """CRC-32 of the vendor variant names in id order.  A cache file stores it and is
    refused where it differs: its ids would name other variants."""
    from tpul2_torch.ops.baselines import VENDOR_VARIANTS
    return zlib.crc32(",".join(VENDOR_VARIANTS).encode())


def render() -> str:
    from tpul2_torch.ops.baselines import VENDOR_VARIANTS

    names = ", ".join(f'"{v}"' for v in VENDOR_VARIANTS)
    return (
        "// GENERATED by tpul2_torch/native/gen_constants.py from tpul2_torch/ops/baselines.py\n"
        "// at every native build. Do not edit.\n"
        "#pragma once\n"
        "#include <cstdint>\n\n"
        "// ops.baselines.VENDOR_VARIANTS, by id\n"
        f"static const char* const kTl2VendorVariants[] = {{{names}}};\n"
        f"constexpr int32_t kTl2VendorVariantCount = {len(VENDOR_VARIANTS)};\n"
        f"constexpr uint32_t kTl2VendorTableCrc = {vendor_table_crc()}u;\n"
    )


if __name__ == "__main__":
    print(render(), end="")
