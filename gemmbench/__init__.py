"""gemmbench: the benchmark of tpul2_torch on the card.

``python3 gemmbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
from the root of a checkout.  Every configuration, workload and metric is a file of its
own, found by the name in ``BENCHMARK.json`` (``spec.py``).  Nothing here imports jax,
jaxlib, flax or the JAX package tpul2; ``reference.py`` imports nothing of tpul2_torch.
"""
