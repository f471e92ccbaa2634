"""tpul2_torch — the PyTorch/CUDA port of tpul2 for one NVIDIA H100 (sm_90a).

A GEMM tuned shape by shape plus its harness, beside the JAX package ``tpul2``, which
stays the reference.  Module names mirror ``tpul2``'s:

  scripts/eval_one_shape_torch.py   one shape: gate -> offline or server bench -> summary
  scripts/run_suite_torch.py        the same per shape of a list, into the CUDA-L2 CSVs
  tpul2_torch.harness               correctness gate, offline and server benches, the
                                    CUDA-graph device timer, summary, the shape suite
  python -m tpul2_torch.autotune    tuner: candidates -> launch screen -> device-time
                                    ranking -> exactness screen -> TuneDB
                                    (data/tunedb_h100.json; server sub-entries too)
  tpul2_torch.dispatch              config resolution (DB -> neighbour -> heuristic,
                                    by mode, kept per shape until the DB changes) and
                                    the candidate entries and their server twins
  tpul2_torch.ops.matmul / batched  wrappers of csrc/tl2_wgmma.cu and csrc/tl2_matmul.cu
                                    (the route picks one per launch) + plain versions
  tpul2_torch.ops.pipelined         the staged K ring: csrc/tl2_wgmma.cu's ring with a
                                    split K on the ring tiles, csrc/tl2_staged.cu on the
                                    32-edge ones (the route picks one) + plain version
  tpul2_torch.ops.baselines         library GEMMs (torch.matmul, cuBLAS, cuBLASLt, and
                                    the cuBLASLt auto-tuning search of ops.lt_autotune)
  tpul2_torch.models                the transformer block and the FFN on the tuned GEMMs,
                                    trained through their autograd (ops.matmul.GemmVjp);
                                    models.entry is __graft_entry__.entry's counterpart
  tpul2_torch.harness.profiling     roofline from the card's peaks by device name,
                                    torch.profiler traces, a step's idle share

This package imports torch and never jax.
"""

__version__ = "0.1.0"

from tpul2_torch.config import KernelConfig  # noqa: F401
from tpul2_torch.dispatch import batched_matmul, matmul  # noqa: F401
