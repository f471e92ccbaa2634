"""The model entry point: the counterpart of ``__graft_entry__.entry()``.

    from tpul2_torch.models.entry import entry
    fn, args = entry()          # on the card; entry(device="cpu") runs the plain versions
    out = fn(*args)             # (512, 1024) bf16
"""

from __future__ import annotations

import torch

from tpul2_torch.models.transformer import block_forward, init_block
from tpul2_torch.utils.platform import check_device

#: The flagship block's widths (``__graft_entry__.entry``).
D_MODEL, D_FF, SEQ, N_HEADS = 1024, 4096, 512, 8


def entry(device: str = "cuda") -> tuple:
    """(fn, example_args): the flagship forward step, a transformer block at d_model 1024,
    d_ff 4096, seq 512 and 8 heads whose every GEMM runs through the tuned dispatch, with
    params from seed 0 and a bf16 x from seed 1.  Raises where ``device`` is absent."""
    check_device(device, "the model entry point")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = init_block(gen, D_MODEL, D_FF, device=device)
    gen.manual_seed(1)
    x = torch.randn((SEQ, D_MODEL), generator=gen, device=device).to(torch.bfloat16)

    def fn(params, x):
        return block_forward(params, x, n_heads=N_HEADS)

    return fn, (params, x)
