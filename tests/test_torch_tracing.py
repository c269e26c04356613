"""The port's tracing layer (utils/profiling.py): the counters registry,
the input pipeline's counters (data/batcher.py) and the train step's
device spans (`mark`, `stamp`, `StepSpans`, `DeviceSpans`), on the CPU,
where a stamp is a host-clock reading.

Bit for bit: the batches of `iterate_graphbatches` against
`pack_batches`, and two train steps with the spans recording against two
without (losses, gradients, parameters and BN statistics).
"""
import time

import numpy as np
import pytest
import torch

from signnet_basisnet_tpu_torch.data import (add_lap_pe, choose_budgets,
                                             iterate_graphbatches,
                                             pack_batches, plan_batches,
                                             synthetic_zinc)
from signnet_basisnet_tpu_torch.graph import from_arrays
from signnet_basisnet_tpu_torch.graph import segment as seg
from signnet_basisnet_tpu_torch.models import gnn_model
from signnet_basisnet_tpu_torch.training import (adam, build_steps, fit,
                                                 make_zinc_predict)
from signnet_basisnet_tpu_torch.utils import profiling

TILE = 64
SIGNNET = dict(pos_enc_dim=8, lap_method="sign_inv", sign_inv_layers=2,
               phi_out_dim=4, pe_aggregate="concat")
NETS = {"GIN": dict(hidden_dim=16, out_dim=16, n_layers=2),
        "GatedGCN": dict(hidden_dim=16, out_dim=16, n_layers=2)}
STEP_REGIONS = {"pe", "convs", "head", "bn", "adam", "step"}


@pytest.fixture
def counters():
    profiling.COUNTERS.reset()
    yield profiling.COUNTERS
    profiling.COUNTERS.reset()


@pytest.fixture(scope="module")
def graphs():
    gs = synthetic_zinc(60, 0, 0, seed=4)["train"]
    add_lap_pe(gs, 8)
    return gs


@pytest.fixture
def tiled():
    seg.set_agg_backend("pallas_tile")
    yield
    seg.set_agg_backend("xla")


def _budgets(graphs, batch=16):
    return choose_budgets(graphs, batch, tile=TILE)


def _model(name, seed=0):
    return gnn_model(name, seed=seed, **NETS[name], **SIGNNET)


def _steps(model):
    return build_steps(model, make_zinc_predict(model, "sign_inv"),
                       adam(model.parameters()))


def test_registry_keeps_the_last_values_by_feed():
    reg = profiling.Registry(keep=3)
    assert reg.newest_feed is None
    assert [reg.new_feed(), reg.new_feed()] == [0, 1]
    assert reg.newest_feed == 1
    for i in range(5):
        reg.record("x", i, feed=i % 2)
    assert reg.values("x") == [2, 3, 4]
    assert reg.values("x", {0}) == [2, 4]
    assert reg.snapshot() == {"x": [(0, 2), (1, 3), (0, 4)]}
    assert reg.values("absent") == []
    reg.reset()
    assert reg.snapshot() == {} and reg.newest_feed is None


def test_plan_batches_is_the_plan_pack_batches_packs(graphs):
    nb, eb, gc = _budgets(graphs)
    plan = plan_batches(graphs, nb, eb, gc, shuffle=True, seed=3, tile=TILE)
    packed = pack_batches(graphs, nb, eb, gc, shuffle=True, seed=3, k=8,
                          tile=TILE)
    assert len(plan) == len(packed) >= 3
    assert sorted(i for g in plan for i in g) == list(range(len(graphs)))
    for group, arrays in zip(plan, packed):
        assert int(arrays["graph_mask"].sum()) == len(group)


def test_iterator_records_its_feed_and_batches_match_pack_batches(
        graphs, counters, monkeypatch):
    """Each `batch_np` of the producer takes at least PACK_S (a sleep
    before the real call), so that the whole epoch's packing before the
    first batch shows whatever else the host is running."""
    from signnet_basisnet_tpu_torch.data import batcher
    nb, eb, gc = _budgets(graphs)
    expect = pack_batches(graphs, nb, eb, gc, shuffle=True, seed=9, k=8,
                          tile=TILE)
    pack_s, real = 0.02, batcher.batch_np

    def slow_batch_np(*args, **kwargs):
        time.sleep(pack_s)
        return real(*args, **kwargs)

    monkeypatch.setattr(batcher, "batch_np", slow_batch_np)
    got = []
    for _ in range(2):
        got.append(list(iterate_graphbatches(graphs, nb, eb, gc,
                                             shuffle=True, seed=9, k=8,
                                             tile=TILE, prefetch=2)))
    assert counters.newest_feed == 1
    for feed, batches in enumerate(got):
        assert len(batches) == len(expect)
        for gb, arrays in zip(batches, expect):
            want = from_arrays(arrays).tensors()
            have = gb.tensors()
            assert have.keys() == want.keys()
            for k in want:
                assert have[k].dtype == want[k].dtype
                assert torch.equal(have[k], want[k]), k
        first = counters.values("pipeline.first_batch_ms", {feed})
        assert len(first) == 1 and first[0] > 0
        assert len(counters.values("pipeline.plan_ms", {feed})) == 1
        pack = counters.values("pipeline.pack_ms", {feed})
        assert len(pack) == len(expect) and min(pack) >= 1e3 * pack_s
        # the first batch waits for the whole epoch's packing
        assert first[0] >= 1e3 * pack_s * len(expect)
        depth = counters.values("pipeline.queue_depth", {feed})
        assert len(depth) == len(expect)
        assert all(0 <= d <= 2 for d in depth)
        assert len(counters.values("pipeline.get_ms", {feed})) == len(expect)


@pytest.mark.parametrize("name", list(NETS))
def test_one_eager_step_leaves_one_sample_of_every_region(
        name, graphs, counters, tiled):
    nb, eb, gc = _budgets(graphs)
    batches = list(iterate_graphbatches(graphs, nb, eb, gc, k=8, tile=TILE))
    train, _ = _steps(_model(name))
    assert isinstance(train.spans, profiling.DeviceSpans)
    train(batches[0], 1e-3)
    samples = counters.values("step.regions")
    assert len(samples) == 1
    (sample,) = samples
    want = STEP_REGIONS | ({"gate"} if name == "GatedGCN" else set())
    assert set(sample) == want
    assert all(v > 0 for v in sample.values())
    for region, ms in sample.items():
        assert ms <= sample["step"], (region, sample)
    # the step's interval is its first stamp to its last, counted once
    assert sample["pe"] + sample["convs"] + sample["adam"] \
        <= sample["step"]
    # tagged with the newest feed iterator's ordinal
    assert counters.snapshot()["step.regions"][0][0] == counters.newest_feed


def _two_steps(name, batches, spans_on, monkeypatch):
    monkeypatch.setattr(profiling, "DEVICE_SPANS", spans_on)
    model = _model(name, seed=7)
    train, _ = _steps(model)
    assert (train.spans is not None) == spans_on
    losses = [train(gb, 1e-3)["loss"] for gb in batches[:2]]
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    state = {n: t.detach().clone() for n, t in
             list(model.named_parameters()) + list(model.named_buffers())}
    return losses, grads, state


@pytest.mark.parametrize("name", list(NETS))
def test_recording_changes_no_bit_of_two_steps(name, graphs, counters,
                                               tiled, monkeypatch):
    nb, eb, gc = _budgets(graphs)
    batches = [from_arrays(a) for a in
               pack_batches(graphs, nb, eb, gc, k=8, tile=TILE)[:2]]
    on = _two_steps(name, batches, True, monkeypatch)
    assert len(counters.values("step.regions")) == 1   # the first step's
    off = _two_steps(name, batches, False, monkeypatch)
    assert len(counters.values("step.regions")) == 1
    for a, b in zip(on[0], off[0]):
        assert torch.equal(a, b)
    for one, other in zip(on[1:], off[1:]):
        assert one.keys() == other.keys() and one
        for k in one:
            assert torch.equal(one[k], other[k]), k


def test_marks_outside_a_train_step_return_their_tensors(graphs, counters,
                                                         tiled, monkeypatch):
    x = torch.randn(3, 4, requires_grad=True)
    y = torch.randn(3)
    assert profiling.mark("bn", True, x) is x
    out = profiling.mark("convs", True, x, None, y)
    assert out[0] is x and out[1] is None and out[2] is y
    applied = []
    real = profiling._Mark.apply
    monkeypatch.setattr(profiling._Mark, "apply",
                        lambda *a: applied.append(a[2]) or real(*a))
    nb, eb, gc = _budgets(graphs)
    gb = from_arrays(pack_batches(graphs, nb, eb, gc, k=8, tile=TILE)[0])
    before = counters.snapshot()
    for name in NETS:
        model = _model(name)
        _, evaluate = _steps(model)
        model.train()
        model(gb, gb.eigvecs).sum().backward()
        evaluate(gb)
    assert applied == []
    assert counters.snapshot() == before


def test_a_tensor_subclass_passes_a_recording_step_untouched():
    class Sub(torch.Tensor):
        pass

    x = torch.randn(2, 3).as_subclass(Sub)
    spans = profiling.StepSpans("cpu")
    with profiling.recording(spans):
        assert profiling.mark("bn", True, x) is x
        y = torch.randn(2, 3, requires_grad=True)
        z = profiling.mark("bn", True, y)
        assert z is not y and torch.equal(z, y)
    assert [(r, p) for r, p, _, _ in spans.marks] == [("bn", "fs")]
    # outside the block the marks are no-ops again
    assert profiling.mark("bn", True, y) is y


def test_a_region_whose_input_has_no_gradient_closes_after_the_backward():
    spans = profiling.StepSpans("cpu")
    w = torch.randn(4, 4, requires_grad=True)
    with profiling.recording(spans):
        profiling.stamp("step", True)
        v = profiling.mark("pe", True, torch.randn(5, 4))  # no gradient
        h = profiling.mark("pe", False, v @ w)
        loss = profiling.mark("head", False, h.sum())   # head not entered
        loss.backward()
        profiling.stamp("adam", True)
        profiling.stamp("adam", False)
        profiling.stamp("step", False)
    phases = [(r, p) for r, p, _, _ in spans.marks]
    assert phases == [("step", "fs"), ("pe", "fs"), ("pe", "fe"),
                      ("head", "fe"), ("head", "bs"), ("pe", "bs"),
                      ("adam", "fs"), ("adam", "fe"), ("step", "fe")]
    stamps = {(r, p): t for r, p, t, _ in spans.marks}
    got = spans.read()
    assert set(got) == {"pe", "adam", "step"}
    assert got["step"] == pytest.approx(
        (spans.marks[-1][2] - spans.marks[0][2]) * 1e3)
    assert got["adam"] == pytest.approx(
        (stamps["adam", "fe"] - stamps["adam", "fs"]) * 1e3)
    want = (stamps["pe", "fe"] - stamps["pe", "fs"]
            + stamps["adam", "fs"] - stamps["pe", "bs"]) * 1e3
    assert got["pe"] == pytest.approx(want)


def test_fit_logs_what_the_counters_saw(graphs, counters, tiled):
    nb, eb, gc = _budgets(graphs)
    model = _model("GIN")
    train, evaluate = _steps(model)
    lines = []
    fit(train, evaluate,
        lambda ep: iterate_graphbatches(graphs, nb, eb, gc, shuffle=True,
                                        seed=ep, k=8, tile=TILE),
        lambda: [from_arrays(pack_batches(graphs, nb, eb, gc, k=8,
                                          tile=TILE)[0])],
        epochs=2, log_every=1, logger=lines.append)
    epochs = [ln for ln in lines if ln.startswith("epoch")]
    assert len(epochs) == 2
    for ln in epochs:
        seen = ln.split(" | ")[1]
        assert seen.startswith("first_batch ") and " pack " in seen
        for counter in ("plan", "wait", "queue"):
            assert f" {counter} " in seen
        for region in ("pe", "convs", "head", "bn", "adam"):
            assert f" {region} " in seen
    assert profiling.counters_line(None).startswith("step ")
    assert np.isfinite(profiling.COUNTERS.values("step.regions")[-1]["step"])


def test_timer_stamp_takes_an_int64_buffer_on_the_card():
    from signnet_basisnet_tpu_torch.ops import timer_stamp
    before = timer_stamp.launches
    with pytest.raises(TypeError):
        timer_stamp(torch.zeros(4, dtype=torch.int64), 0)
    with pytest.raises(TypeError):
        timer_stamp(torch.zeros(4, dtype=torch.float32), 0)
    assert timer_stamp.launches == before


def test_a_step_in_every_eight_is_read_once_its_stamps_arrive(
        monkeypatch, counters):
    """The card's path (stamps copied to pinned memory behind an event), with
    a copy that arrives when the test says: a replay is copied out on the
    first call and then every `EVERY` calls, but never while a copy waits to
    be read."""
    class Copy:
        taken = []

        def take(self, spans):
            self.taken.append(spans.n)
            self.n, self.ready = spans.n, False

        def done(self):
            return self.ready

        def read(self):
            return {"step": float(self.n)}

    class Stamps:
        cuda, n = True, 0

    spans = profiling.DeviceSpans()
    spans.recorder, spans._copy = Stamps(), Copy()
    assert profiling.DeviceSpans.EVERY == 8
    for n in range(30):
        assert not spans.sample() or n in (3, 12)
        if n == 2:      # the copy of call 0 arrives
            spans._copy.ready = True
        spans.recorder.n = n
        if spans.due():     # a captured step replays its stamped graph
            spans.finished()
        if n == 11:     # the copy of call 8 arrives
            spans._copy.ready = True
    # copied at calls 0 and 8 (read at calls 3 and 12) and 16, whose copy
    # never arrives, so no later call is copied
    assert Copy.taken == [0, 8, 16]
    assert [s["step"] for s in counters.values("step.regions")] == [0.0, 8.0]
