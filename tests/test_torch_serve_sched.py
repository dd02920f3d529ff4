"""repro_torch.serve (the port's copy of the scheduler): the fake-clock
scheduler tests of tests/test_serve_sched.py, aimed at the port, plus
the bitplane aggregator on a small logic network through the kernels'
plain versions."""
import numpy as np
import pytest

from repro_torch.serve import (FakeClock, MicroBatchScheduler, RejectReason,
                               RequestRejected, SchedConfig)


def _sum_executor(log):
    def ex(x):
        log.append(x.shape[0])
        return x.sum(axis=-1)
    return ex


# ---------------------------------------------------------------------------
# Batch formation: deadline flush vs full-batch flush
# ---------------------------------------------------------------------------

def test_full_batch_flushes_without_deadline():
    clk, log = FakeClock(), []
    s = MicroBatchScheduler(_sum_executor(log),
                            SchedConfig(max_batch=4, max_wait_us=1e6),
                            clock=clk)
    futs = [s.submit(np.full((3,), i, np.float32)) for i in range(4)]
    # four 1-row requests = max_batch: flush immediately, no time passed
    assert s.poll() == 4
    assert log == [4]
    assert [f.result(0) for f in futs] == [0.0, 3.0, 6.0, 9.0]


def test_deadline_flush_partial_batch():
    clk, log = FakeClock(), []
    s = MicroBatchScheduler(_sum_executor(log),
                            SchedConfig(max_batch=64, max_wait_us=200.0),
                            clock=clk)
    f = s.submit(np.ones((2, 3), np.float32))
    assert s.poll() == 0                 # under max_batch, deadline not hit
    clk.advance_us(199.0)
    assert s.poll() == 0                 # 1 us early
    clk.advance_us(1.0)
    assert s.poll() == 1                 # exactly at max_wait_us
    assert log == [2]
    np.testing.assert_allclose(f.result(0), [3.0, 3.0])
    assert f.latency_us == 200.0         # true enqueue->complete time


def test_multirow_requests_never_split_and_fill_batches():
    clk, log = FakeClock(), []
    s = MicroBatchScheduler(_sum_executor(log),
                            SchedConfig(max_batch=4, max_wait_us=10.0),
                            clock=clk)
    fa = s.submit(np.ones((3, 2)))
    fb = s.submit(np.ones((2, 2)))       # does not fit with fa: 5 > 4
    clk.advance_us(11.0)
    assert s.poll() == 2                 # two batches, FIFO preserved
    assert log == [3, 2]
    assert fa.result(0).shape == (3,) and fb.result(0).shape == (2,)


# ---------------------------------------------------------------------------
# Admission control / backpressure
# ---------------------------------------------------------------------------

def test_backpressure_typed_reject():
    s = MicroBatchScheduler(_sum_executor([]),
                            SchedConfig(max_batch=8, max_queue=3),
                            clock=FakeClock())
    for _ in range(3):
        s.submit(np.ones(2))
    with pytest.raises(RequestRejected) as e:
        s.submit(np.ones(2))
    assert e.value.reason == RejectReason.QUEUE_FULL
    with pytest.raises(RequestRejected) as e:
        s.submit(np.ones((9, 2)))        # more rows than one batch
    assert e.value.reason == RejectReason.TOO_LARGE
    snap = s.metrics.snapshot()
    assert snap["rejected"] == 2
    assert snap["rejected_by_reason"] == {"queue_full": 1, "too_large": 1}
    assert s.drain() == 3                # queued work still completes


def test_shutdown_rejects_new_submissions():
    s = MicroBatchScheduler(_sum_executor([]), SchedConfig(),
                            clock=FakeClock())
    s.start()
    s.stop(drain=True)
    with pytest.raises(RequestRejected) as e:
        s.submit(np.ones(2))
    assert e.value.reason == RejectReason.SHUTDOWN


def test_deadline_expiry_shed_with_typed_reject():
    clk, log = FakeClock(), []
    s = MicroBatchScheduler(_sum_executor(log),
                            SchedConfig(max_batch=8, max_wait_us=1e6,
                                        n_priorities=1,
                                        lane_slo_us=(100.0,)), clock=clk)
    f = s.submit(np.ones(2))
    clk.advance_us(150.0)                # past the lane-0 SLO
    assert s.drain() == 1                # resolved by shedding, not served
    assert log == []                     # never reached the executor
    with pytest.raises(RequestRejected) as e:
        f.result(0)
    assert e.value.reason == RejectReason.DEADLINE_EXCEEDED
    snap = s.metrics.snapshot()
    assert snap["shed"] == 1 and snap["completed"] == 0
    assert snap["deadline_miss_rate"] == 1.0
    assert snap["lanes"]["0"]["shed"] == 1


def test_explicit_deadline_overrides_lane_slo():
    clk, log = FakeClock(), []
    s = MicroBatchScheduler(_sum_executor(log),
                            SchedConfig(max_batch=8, max_wait_us=1e6,
                                        n_priorities=1,
                                        lane_slo_us=(100.0,)), clock=clk)
    f = s.submit(np.ones(2), deadline_us=500.0)
    clk.advance_us(150.0)                # past the lane SLO, within budget
    assert s.poll() == 0                 # not expired, not yet due
    clk.advance_us(350.0)
    assert s.poll() == 1                 # flushed at its own deadline
    assert f.result(0) == 2.0


def test_nonpositive_budget_rejected_at_admission():
    s = MicroBatchScheduler(_sum_executor([]), SchedConfig(),
                            clock=FakeClock())
    with pytest.raises(RequestRejected) as e:
        s.submit(np.ones(2), deadline_us=-5.0)
    assert e.value.reason == RejectReason.DEADLINE_EXCEEDED


def test_edf_ordering_within_lane_vs_fifo():
    clk, order = FakeClock(), []

    def ex(x):
        order.extend(int(v) for v in x[:, 0])
        return x[:, 0]

    s = MicroBatchScheduler(ex, SchedConfig(max_batch=1, n_priorities=1),
                            clock=clk)
    s.submit(np.full((1, 1), 1.0), deadline_us=500.0)
    s.submit(np.full((1, 1), 2.0), deadline_us=100.0)  # tighter, later
    s.drain()
    assert order == [2, 1]               # EDF, not arrival FIFO

    order.clear()
    s2 = MicroBatchScheduler(ex, SchedConfig(max_batch=1, n_priorities=1),
                             clock=clk)
    s2.submit(np.full((1, 1), 1.0))      # no deadlines: FIFO preserved
    s2.submit(np.full((1, 1), 2.0))
    s2.drain()
    assert order == [1, 2]


def test_per_lane_miss_rate_accounting():
    clk = FakeClock()

    def slow_ex(x):                      # execution outlives the tight SLO
        clk.advance_us(150.0)
        return x.sum(axis=-1)

    s = MicroBatchScheduler(slow_ex,
                            SchedConfig(max_batch=8, max_wait_us=1e6,
                                        n_priorities=2,
                                        lane_slo_us=(100.0, 10_000.0)),
                            clock=clk)
    tight = s.submit(np.ones(2), priority=0)
    loose = s.submit(np.ones(2), priority=1)
    assert s.drain() == 2
    assert tight.result(0) == 2.0 and loose.result(0) == 2.0
    snap = s.metrics.snapshot()
    # lane 0 completed but 50 µs past its deadline: a served-late miss
    assert snap["lanes"]["0"]["missed"] == 1
    assert snap["lanes"]["0"]["deadline_miss_rate"] == 1.0
    assert snap["lanes"]["1"]["missed"] == 0
    assert snap["lanes"]["1"]["deadline_miss_rate"] == 0.0
    assert snap["lanes"]["1"]["mean_slack_us"] == pytest.approx(9850.0)
    # now an expiry shed on the tight lane joins the miss accounting
    f = s.submit(np.ones(2), priority=0)
    clk.advance_us(200.0)
    s.drain()
    with pytest.raises(RequestRejected):
        f.result(0)
    snap = s.metrics.snapshot()
    assert snap["lanes"]["0"]["shed"] == 1
    assert snap["deadline_miss_rate"] == pytest.approx(2 / 3)


def test_next_deadline_wakes_on_slo_not_arrival_age():
    clk = FakeClock(1000.0)
    s = MicroBatchScheduler(_sum_executor([]),
                            SchedConfig(max_wait_us=1e6, n_priorities=1,
                                        lane_slo_us=(100.0,)), clock=clk)
    assert s.next_deadline_us() is None
    s.submit(np.ones(2))
    assert s.next_deadline_us() == 1100.0    # the SLO, not enqueue+1e6

    s2 = MicroBatchScheduler(_sum_executor([]),
                             SchedConfig(max_wait_us=200.0), clock=clk)
    s2.submit(np.ones(2))
    assert s2.next_deadline_us() == 1200.0   # no SLO: arrival age cap


# ---------------------------------------------------------------------------
# Deadline-aware replica dispatch
# ---------------------------------------------------------------------------

def test_priority_ordering_within_flush():
    clk, order = FakeClock(), []

    def ex(x):
        order.extend(int(v) for v in x[:, 0])
        return x[:, 0]

    s = MicroBatchScheduler(ex, SchedConfig(max_batch=2, max_wait_us=10.0,
                                            n_priorities=2), clock=clk)
    lo = s.submit(np.full((1, 1), 9.0), priority=1)
    hi = [s.submit(np.full((1, 1), float(i)), priority=0) for i in range(3)]
    clk.advance_us(11.0)
    s.poll()
    # lane 0 drains FIFO first; the lone low-priority request flushes last
    assert order == [0, 1, 2, 9]
    assert lo.result(0) == 9.0 and hi[0].result(0) == 0.0


def test_bad_priority_rejected():
    s = MicroBatchScheduler(_sum_executor([]),
                            SchedConfig(n_priorities=2), clock=FakeClock())
    with pytest.raises(RequestRejected) as e:
        s.submit(np.ones(2), priority=5)
    assert e.value.reason == RejectReason.BAD_PRIORITY


def test_executor_error_fails_batch_not_scheduler():
    clk = FakeClock()
    calls = []

    def flaky(x):
        calls.append(x.shape[0])
        if len(calls) == 1:
            raise RuntimeError("boom")
        return x.sum(axis=-1)

    s = MicroBatchScheduler(flaky, SchedConfig(max_batch=2), clock=clk)
    bad = [s.submit(np.ones(2)) for _ in range(2)]
    assert s.poll() == 2                 # resolved, but with the error set
    for f in bad:
        with pytest.raises(RuntimeError):
            f.result(0)
    good = [s.submit(np.ones(2)) for _ in range(2)]
    s.poll()
    assert [f.result(0) for f in good] == [2.0, 2.0]
    assert s.metrics.snapshot()["errors"] == 2


# ---------------------------------------------------------------------------
# Bitplane aggregation on a small seeded network (plain kernel versions)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def demo_engine():
    import torch

    from repro_torch.configs.jsc import JSC_DEMO
    from repro_torch.data.jsc import make_jsc
    from repro_torch.models.mlp import final_masks, init_mlp, to_logic
    from repro_torch.serving.engine import LogicEngine
    model = init_mlp(JSC_DEMO, torch.Generator().manual_seed(3))
    model.set_masks(final_masks(JSC_DEMO, model))
    net = to_logic(JSC_DEMO, model)
    eng = LogicEngine(net, 5, max_batch=64, backend="bitplane",
                      engine="cuda-streamed", device="cpu")
    gather = LogicEngine(net, 5, max_batch=64, device="cpu")
    return eng, gather, make_jsc(200, seed=5)[0]


def test_bitplane_aggregator_packs_requests_into_lanes(demo_engine):
    from repro_torch.serve import BitplaneAggregator
    eng, gather, x = demo_engine
    agg = BitplaneAggregator(eng.bitnet, 5)
    np.testing.assert_array_equal(agg(x[:40]), gather.classify(x[:40]))
    # 40 requests -> 2 lane-words per input wire (32 + 8 lanes)
    n_wires = eng.net.n_inputs * eng.bitnet.in_bits
    assert tuple(agg.pack_requests(x[:40]).shape) == (n_wires, 2)
    assert agg.mean_lane_occupancy == pytest.approx(40 / 64)


def test_aggregator_occupancy_counts_real_rows_under_pad_rows(demo_engine):
    from repro_torch.serve import BitplaneAggregator
    eng, gather, x = demo_engine
    agg = BitplaneAggregator(eng.bitnet, 5, pad_rows=64)
    np.testing.assert_array_equal(agg(x[:16]), gather.classify(x[:16]))
    assert agg.n_evals == 1 and agg.n_rows == 16
    assert agg.mean_lane_occupancy == pytest.approx(16 / 32)
    assert agg.n_pad_rows == 48 and agg.n_partial_packs == 1
    assert agg.n_features == eng.net.n_inputs


def test_scheduled_single_rows_match_direct_classify(demo_engine):
    eng, gather, x = demo_engine
    clk = FakeClock()
    s = MicroBatchScheduler(eng.scheduler_executor(),
                            SchedConfig(max_batch=64, max_wait_us=100.0,
                                        max_queue=200), clock=clk)
    futs = [s.submit(x[i]) for i in range(96)]
    assert s.drain() == 96
    got = np.array([int(f.result(0)) for f in futs], np.int32)
    np.testing.assert_array_equal(got, gather.classify(x[:96]))
    snap = s.metrics.snapshot()
    assert snap["n_batches"] == 2
    assert snap["mean_batch_occupancy"] == pytest.approx(0.75)
