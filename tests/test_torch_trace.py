"""The port's spans and counters (``tpul2_torch.trace``) on the CPU: tracing off records
nothing; on (a profiler, or ``trace.recording()``) each call's spans nest by layer and
share its id, and the profiler's trace names them; the counters count each route and the
resolve memo; a session's bound counts the spans it drops."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpul2_torch import dispatch, trace
from tpul2_torch.autotune import db as db_mod
from tpul2_torch.config import KernelConfig

M, N, K = 16, 32, 64
LAYERS = {"tl2.call", "tl2.dispatch", "tl2.wrapper", "tl2.sentinel"}


@pytest.fixture(autouse=True)
def empty_tunedb(tmp_path, monkeypatch):
    """The heuristic for every shape: no DB file."""
    monkeypatch.setenv(db_mod.ENV_VAR, str(tmp_path / "empty_tunedb.json"))
    db_mod.reset_default_db()
    yield
    db_mod.reset_default_db()


def _operands(batch=None):
    gen = torch.Generator().manual_seed(5)
    lead = () if batch is None else (batch,)
    return (torch.randn((*lead, M, K), generator=gen).bfloat16(),
            torch.randn((*lead, K, N), generator=gen).bfloat16())


def _calls():
    """A kernel route, the sentinel by an explicit config, a batched call and a candidate
    entry: the layers each crosses."""
    a, b = _operands()
    a3, b3 = _operands(2)
    dispatch.matmul(a, b)
    dispatch.matmul(a, b, config=KernelConfig.vendor())
    dispatch.batched_matmul(a3, b3)
    dispatch.cuda_l2_h100_f32(a, b, b.t().contiguous())
    return [("matmul", ["tl2.dispatch", "tl2.wrapper"]), ("matmul", ["tl2.sentinel"]),
            ("batched_matmul", ["tl2.dispatch", "tl2.wrapper"]),
            ("cuda_l2_h100_f32", ["tl2.dispatch", "tl2.wrapper"])]


def test_tracing_off_records_no_span():
    assert not trace.on()
    before = [(s, len(s.spans)) for s in trace.SESSIONS]
    _calls()
    assert [(s, len(s.spans)) for s in trace.SESSIONS] == before


@pytest.mark.parametrize("how", ["profiler", "recording"])
def test_spans_nest_by_layer_and_share_the_call_id(how):
    if how == "profiler":
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            assert trace.on()
            want = _calls()
        session = trace.profiled_sessions()[-1]
        assert session.host is True
        assert LAYERS <= {e.name for e in prof.events()}  # on the profiler's own trace
    else:
        with trace.recording() as session:
            want = _calls()
    assert not trace.on()
    spans = session.read()
    roots = [s for s in spans if s.name == "tl2.call"]
    assert [s.info["entry"] for s in roots] == [entry for entry, _ in want]
    assert len({s.call for s in roots}) == len(want)
    for root, (_, inner) in zip(roots, want):
        mine = [s for s in spans if s.call == root.call]
        assert mine[0] is root and root.parent is None
        assert [s.name for s in mine[1:]] == inner
        assert all(s.parent is root and s.shape == root.shape for s in mine[1:])
        assert all(root.start <= s.start <= s.end <= root.end for s in mine)
        assert all(s.device_ms is None for s in mine)  # no card: no device interval
    assert roots[2].shape == (M, N, K, 2, "float32")
    dispatched = [s for s in spans if s.name == "tl2.dispatch"]
    assert [s.info["source"] for s in dispatched] == ["heuristic"] * 3
    sentinel = next(s for s in spans if s.name == "tl2.sentinel")
    assert sentinel.info == {"route": "sentinel", "variant": "torch_matmul"}


def test_counters_count_routes_and_the_memo():
    before = {group: trace.counts(group) for group in ("call", "memo", "resolve")}
    launches = trace.launch_counts()
    _calls()

    def moved(group):
        now = trace.counts(group)
        return {key: n - before[group].get(key, 0) for key, n in now.items()
                if n != before[group].get(key, 0)}

    assert moved("call") == {("matmul", "ring"): 1, ("matmul", "sentinel"): 1,
                             ("batched_matmul", "ring"): 1, ("cuda_l2_h100_f32", "ring"): 1}
    # the shape's first resolution misses, the candidate entry's of the same shape hits
    assert moved("memo") == {"miss": 1, "hit": 2} and moved("resolve") == {"heuristic": 1}
    assert trace.launch_counts() == launches  # the CPU runs the plain versions


def test_the_store_bound_counts_drops(monkeypatch):
    monkeypatch.setattr(trace, "MAX_SPANS", 5)
    a, b = _operands()
    with trace.recording() as session:
        for _ in range(3):
            dispatch.matmul(a, b)
    assert [s.name for s in session.spans] == ["tl2.call", "tl2.dispatch", "tl2.wrapper",
                                               "tl2.call", "tl2.dispatch"]
    assert session.dropped == 4
