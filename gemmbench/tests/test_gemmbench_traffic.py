"""The seeded generator: the same seed gives the same shapes, order, offsets and data."""

import torch

from gemmbench import traffic
from gemmbench.tests.conftest import TINY_GRID, TINY_LAYERS, tiny_workloads

SEEDS = [0, 7, 2 ** 31 + 11, -3]


def _grid(seed):
    wl = tiny_workloads()["tiny_grid.f32_offline"]
    return traffic.make_grid(TINY_GRID, wl, seed, torch.device("cpu"))


def test_pass_order_is_the_seeds_and_covers_every_shape():
    for seed in SEEDS:
        a, b = traffic.pass_order(seed, 1000, 0), traffic.pass_order(seed, 1000, 0)
        assert (a == b).all() and sorted(a.tolist()) == list(range(1000))
        assert (a != traffic.pass_order(seed, 1000, 1)).any()
    assert (traffic.pass_order(1, 1000, 0) != traffic.pass_order(2, 1000, 0)).any()


def test_grid_operands_and_offsets_repeat_by_seed():
    one, two, other = _grid(2 ** 31 + 11), _grid(2 ** 31 + 11), _grid(5)
    assert one.shapes == two.shapes == other.shapes
    assert torch.equal(one.a_pool, two.a_pool) and not torch.equal(one.a_pool, other.a_pool)
    offs = [[t.next_a(m, k)[0] for m, _, k in t.shapes] for t in (one, two)]
    assert offs[0] == offs[1] and all(o % traffic.ALIGN == 0 for o in offs[0])
    for (k, n), sets in one.b_sets.items():
        for b, b_t in sets:
            assert b.is_contiguous() and b_t.is_contiguous() and torch.equal(b_t, b.t())


def test_small_b_rotates_over_the_burst_and_large_b_does_not():
    tr = _grid(0)
    assert len(tr.b_sets[16, 16]) == tr.burst_calls
    assert len(tr.b_sets[1536, 1536]) == 1  # 4.7 MB, above the tiny cell's 1 MB


def test_a_pool_rotates_and_wraps():
    tr = _grid(0)
    size = tr.a_pool.numel()
    seen = [tr.next_a(1536, 1536)[0] for _ in range(5)]
    assert all(0 <= o and o + 1536 * 1536 <= size for o in seen)
    assert seen[0] != seen[1]


def test_layers_and_samples_repeat_by_seed():
    wl = tiny_workloads()["tiny_layers.prefill"]
    one, two = (traffic.make_layers(TINY_LAYERS, wl, 9, torch.device("cpu")) for _ in "ab")
    assert one.first_layer == two.first_layer
    assert all(torch.equal(x, y) for r1, r2 in zip(one.weights, two.weights)
               for x, y in zip(r1, r2))
    assert [w.shape for w in one.weights[0]] == [(1536, 96), (512, 64), (2048, 32),
                                                 (3, 1536, 48)]
    assert [a.shape for a in one.acts[0]] == [(16, 1536), (16, 512), (16, 2048),
                                              (3, 16, 1536)]
    assert one.loads == two.loads
    assert traffic.layer_sample(9, 58, 2) == traffic.layer_sample(9, 58, 2)
    shapes = traffic.grid_shapes([16, 32, 1536])
    classes = {i: i % 3 for i in range(len(shapes))}
    plan = traffic.grid_sample(4, shapes, classes, 5, 4, 1 << 30)
    assert plan == traffic.grid_sample(4, shapes, classes, 5, 4, 1 << 30)
    assert {classes[i] for i in plan} == {0, 1, 2} and len(plan) == 8


def test_expert_loads_by_hand():
    # DeepSeek-V3's prefill share: 4096 tokens x 8 experts each over 8 held, skew 0.5
    pre = traffic.expert_loads(4096, 8, 8, 0.5)
    assert sum(pre) == 32768 and pre[0] == 6144 and pre[-1] == 2048
    assert pre == sorted(pre, reverse=True)
    assert traffic.expert_loads(64, 8, 2, 0.5) == [384, 128]  # the decode share
    assert traffic.expert_loads(10, 1, 3, 0.0) == [4, 3, 3]
    assert traffic.expert_loads(5, 2, 1, 0.5) == [10]


def test_every_layer_deals_the_same_loads_by_the_seed():
    wl = tiny_workloads()["tiny_layers.prefill"]
    tr = traffic.make_layers(TINY_LAYERS, wl, 3, torch.device("cpu"))
    profile = traffic.expert_loads(16, 2, 3, wl["expert_skew"])
    assert all(sorted(loads, reverse=True) == profile for loads in tr.loads)
    assert tr.rows(TINY_LAYERS["linears"][3]) == max(profile) and tr.rows({}) == 16
    other = traffic.make_layers(TINY_LAYERS, wl, 4, torch.device("cpu"))
    assert sorted(map(sorted, other.loads)) == sorted(map(sorted, tr.loads))
