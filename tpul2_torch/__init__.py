"""tpul2_torch — the PyTorch/CUDA port of tpul2 for one NVIDIA H100 (sm_90a).

A GEMM tuned shape by shape plus its harness, beside the JAX package ``tpul2``, which
stays the reference.  Module names mirror ``tpul2``'s:

  scripts/eval_one_shape_torch.py   driver: gate -> offline bench -> summary
  tpul2_torch.harness               correctness gate, offline bench, summary
  python -m tpul2_torch.autotune    tuner: candidates -> launch screen -> timing ->
                                    exactness screen -> TuneDB (tunedb_h100.json)
  tpul2_torch.dispatch              config resolution (DB -> neighbour -> heuristic,
                                    kept per shape until the DB changes) and the
                                    candidate entries
  tpul2_torch.ops.matmul / batched  wrappers of csrc/tl2_wgmma.cu and csrc/tl2_matmul.cu
                                    (the route picks one per launch) + plain versions
  tpul2_torch.ops.pipelined         the staged K ring: csrc/tl2_wgmma.cu's ring with a
                                    split K on the ring tiles, csrc/tl2_staged.cu on the
                                    32-edge ones (the route picks one) + plain version
  tpul2_torch.ops.baselines         library GEMMs (torch.matmul, cuBLAS, cuBLASLt)

This package imports torch and never jax.
"""

__version__ = "0.1.0"

from tpul2_torch.config import KernelConfig  # noqa: F401
from tpul2_torch.dispatch import batched_matmul, matmul  # noqa: F401
