"""The one generator of the benchmark's traffic, driven by a workload's parameters.

Everything a run feeds the program is drawn here from ``--seed``: the order of the grid's
shapes on each pass, the operands' places in the device pools, the weights and the
activations, and which outputs the check keeps.  The same seed gives the same shapes, the
same order and the same offsets; every seed gives the same sizes and the same amount of
work, in another order and with other values.

Two loop kinds exist (``workload["loop"]``):

* ``grid_bursts``: the configuration's ``dims`` cubed, each shape in bursts of
  ``burst_calls`` back-to-back calls, in a new seeded order on each pass over the grid.
  A comes from a rotating pool (``a_pool_bytes``, 256-byte aligned offsets), so a call
  does not find its A in L2 from the call before.  B and its transpose b_t come in
  ``burst_calls`` sets per (K, N) where B is smaller than ``b_rotate_below_bytes``, and in
  one set above it (a larger B does not fit L2): b_t is B's transpose, as the ABI states,
  so the two cannot be cut from a pool at independent offsets.
* ``layer_steps``: the configuration's ``linears`` at ``m`` rows, one step being one
  layer's linears in order, cycling the configuration's ``num_hidden_layers`` layers of
  weights (held as b (K, N)), with ``act_sets`` seeded sets of activations in turn.  A
  ``grouped`` linear is the routed experts this card holds (``n_routed_experts``): one
  (K, N) weight per expert, and the rows routed to each expert in a batch padded to the
  most any expert takes (``expert_loads``).  The loads are a fixed profile of the
  workload's ``expert_skew``, the same for every seed; the seed deals them to the experts
  of each layer.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
import torch

#: Offsets into a pool are multiples of this many bf16 elements (256 bytes).
ALIGN = 128
#: Elements per device randn call: torch's generators are used below 2**31 elements.
CHUNK = 1 << 30


def rng(seed: int, *path: int) -> np.random.Generator:
    """A numpy generator for one purpose (``path``) of a run of ``seed``; any whole number,
    negative or above 64 bits included, is folded onto 64 bits."""
    return np.random.default_rng([seed % (1 << 64), *path])


def device_seed(seed: int, *path: int) -> int:
    return int(rng(seed, *path).integers(0, 1 << 62))


def _round_up(x: int, to: int = ALIGN) -> int:
    return -(-x // to) * to


def randn(numel: int, seed: int, path: tuple, device) -> torch.Tensor:
    """A flat bf16 tensor of standard normal values made on ``device`` from the seed, in
    calls of at most ``CHUNK`` elements."""
    out = torch.empty(numel, dtype=torch.bfloat16, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(device_seed(seed, *path))
    for start in range(0, numel, CHUNK):
        out[start:start + CHUNK].normal_(generator=gen)
    return out


def grid_shapes(dims: list) -> list:
    return list(itertools.product(dims, dims, dims))


def pass_order(seed: int, n_shapes: int, pass_index: int) -> np.ndarray:
    """The order of the grid's shapes on one pass."""
    return rng(seed, 1, pass_index).permutation(n_shapes)


@dataclass
class GridTraffic:
    """The grid's operands on the device and the rotation over them."""
    shapes: list
    burst_calls: int
    a_pool: torch.Tensor
    b_sets: dict          # (k, n) -> list of (b, b_t)
    cursor: int = 0

    def next_a(self, m: int, k: int) -> tuple:
        """(offset, A) for the next call: the next place in the rotating pool."""
        size = m * k
        if self.cursor + size > self.a_pool.numel():
            self.cursor = 0
        off = self.cursor
        self.cursor = off + _round_up(size)
        return off, self.a_pool[off:off + size].view(m, k)

    def a_at(self, off: int, m: int, k: int) -> torch.Tensor:
        return self.a_pool[off:off + m * k].view(m, k)


def make_grid(config: dict, workload: dict, seed: int, device) -> GridTraffic:
    dims = config["dims"]
    shapes = grid_shapes(dims)
    burst = workload["burst_calls"]
    largest_a = max(m * k for m, _, k in shapes)
    a_elems = _round_up(max(workload["a_pool_bytes"] // 2, 2 * largest_a))
    a_pool = randn(a_elems, seed, (2,), device)
    pairs = [(k, n) for k in dims for n in dims]
    counts = {(k, n): burst if 2 * k * n < workload["b_rotate_below_bytes"] else 1
              for k, n in pairs}
    total = sum(_round_up(k * n) * counts[k, n] for k, n in pairs)
    b_flat = randn(total, seed, (3,), device)
    bt_flat = torch.empty_like(b_flat)
    b_sets, off = {}, 0
    for k, n in pairs:
        sets = []
        for _ in range(counts[k, n]):
            b = b_flat[off:off + k * n].view(k, n)
            b_t = bt_flat[off:off + k * n].view(n, k)
            b_t.copy_(b.t())
            sets.append((b, b_t))
            off += _round_up(k * n)
        b_sets[k, n] = sets
    return GridTraffic(shapes, burst, a_pool, b_sets)


def expert_loads(m: int, per_token: int, experts: int, skew: float) -> list:
    """Rows routed to each expert held here in one step, most first: ``m`` tokens times
    ``per_token`` experts each, shared over ``experts`` (as each card of an expert-parallel
    deployment takes that many on average), spread linearly from (1 + skew) to (1 - skew)
    times the mean.  The sum is exact."""
    total = m * per_token
    mean = total / experts
    raw = [mean * (1 + skew * (1 - 2 * i / (experts - 1))) if experts > 1 else mean
           for i in range(experts)]
    loads = [int(round(x)) for x in raw]
    loads[0] += total - sum(loads)
    return loads


@dataclass
class LayerTraffic:
    """The layers' weights and the activations on the device."""
    m: int
    linears: list              # [{"name", "n", "k", "grouped"?}]
    weights: list              # [layer][linear] -> (K, N), a grouped one (E, K, N)
    acts: list                 # [set][linear] -> (M, K), a grouped one (E, capacity, K)
    first_layer: int
    loads: list                # [layer] -> rows of each held expert, in expert order

    @property
    def layers(self) -> int:
        return len(self.weights)

    def rows(self, lin: dict) -> int:
        """Rows of a linear's A: ``m``, or for a grouped one the padded batch's."""
        return max(self.loads[0]) if lin.get("grouped") else self.m


def make_layers(config: dict, workload: dict, seed: int, device) -> LayerTraffic:
    linears = config["linears"]
    layers = config["num_hidden_layers"]
    m = workload["m"]
    experts = config["n_routed_experts"]
    profile = expert_loads(m, config["num_experts_per_tok"], experts,
                           workload.get("expert_skew", 0.0))
    loads = [[profile[i] for i in rng(seed, 9, layer).permutation(experts)]
             for layer in range(layers)]
    capacity = max(profile)
    batch = [experts if lin.get("grouped") else 1 for lin in linears]
    rows = [capacity if lin.get("grouped") else m for lin in linears]

    w_shapes = [(e, lin["k"], lin["n"]) for e, lin in zip(batch, linears)]
    a_shapes = [(e, r, lin["k"]) for e, r, lin in zip(batch, rows, linears)]
    w_flat = randn(sum(_round_up(int(np.prod(s))) for s in w_shapes) * layers, seed, (4,),
                   device)
    a_flat = randn(sum(_round_up(int(np.prod(s))) for s in a_shapes) * workload["act_sets"],
                   seed, (5,), device)

    def cut(flat, shapes, count):
        out, off = [], 0
        for _ in range(count):
            row = []
            for lin, shape in zip(linears, shapes):
                size = int(np.prod(shape))
                t = flat[off:off + size]
                row.append(t.view(*shape) if lin.get("grouped") else t.view(*shape[1:]))
                off += _round_up(size)
            out.append(row)
        return out

    first = int(rng(seed, 6).integers(0, layers))
    return LayerTraffic(m, linears, cut(w_flat, w_shapes, layers),
                        cut(a_flat, a_shapes, workload["act_sets"]), first, loads)


def grid_sample(seed: int, shapes: list, classes: dict, extra: int, burst: int,
                max_out_bytes: int) -> dict:
    """The grid shapes whose output the check keeps: {shape index: call in its burst}.

    One shape of every class of ``classes`` (the program's route for each shape, read at
    set-up), drawn from the seed, then ``extra`` more drawn from the seed, in that order; a
    shape whose bf16 C would take the kept outputs past ``max_out_bytes`` is passed over."""
    g = rng(seed, 7)
    by_class = {}
    for idx, key in classes.items():
        by_class.setdefault(key, []).append(idx)
    chosen = [int(g.choice(sorted(members)))
              for _, members in sorted(by_class.items(), key=lambda kv: str(kv[0]))]
    taken = set(chosen)
    chosen += [int(i) for i in g.permutation(len(shapes)) if int(i) not in taken][:extra]
    kept, used = {}, 0
    for idx in chosen:
        m, n, _ = shapes[idx]
        if used + 2 * m * n > max_out_bytes:
            continue
        used += 2 * m * n
        kept[idx] = int(g.integers(0, burst))
    return kept


def layer_sample(seed: int, layers: int, count: int) -> list:
    """The layers whose outputs (every linear's) the check keeps."""
    return sorted(int(i) for i in rng(seed, 8).choice(layers, size=min(count, layers),
                                                       replace=False))
