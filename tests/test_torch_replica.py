"""repro_torch.serve.replica against repro.serve.replica: the replica
tests of tests/test_serve_sched.py aimed at the port, then the same
dispatch scenarios driven in both packages under a ``FakeClock`` —
pick order per policy, failover, the failover budget re-stamp,
``stats()``, EWMA seeding and re-seeding, ``publish`` and tracer
wiring — compared exactly, and ``build_logic_replicas`` serving a
small logic network on the CPU with the labels of ``classify``."""
import numpy as np
import pytest
import torch

import repro.obs as R
import repro.serve as RS
import repro_torch.obs as P
import repro_torch.serve as PS
from repro_torch.serve import (AllReplicasDown, FakeClock,
                               MicroBatchScheduler, RejectReason,
                               ReplicaSet, RequestRejected, SchedConfig)

PKGS = {"ref": (R, RS), "port": (P, PS)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # JSC-S training and synthesis here are many tiny ops, slowest
    # with a thread pool (and beside other test workers)
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The reference's replica tests, aimed at the port
# ---------------------------------------------------------------------------

def test_replica_failover_restamps_remaining_budget():
    clk = FakeClock()

    def crash_slowly(x):
        clk.advance_us(200.0)            # the failure ate the whole budget
        raise RuntimeError("replica crash")

    rs = ReplicaSet([crash_slowly, lambda x: x.sum(axis=-1)], policy="rr",
                    clock=clk)
    with pytest.raises(RequestRejected) as e:
        rs(np.ones((1, 2)), deadline_us=100.0)
    assert e.value.reason == RejectReason.DEADLINE_EXCEEDED
    # the healthy replica is still up: budget-free traffic flows on
    np.testing.assert_allclose(rs(np.ones((1, 2))), [2.0])
    assert [r["healthy"] for r in rs.stats()] == [False, True]


def test_replica_failover_within_budget_still_retries():
    clk = FakeClock()

    def crash_fast(x):
        clk.advance_us(10.0)
        raise RuntimeError("replica crash")

    rs = ReplicaSet([crash_fast, lambda x: x.sum(axis=-1)], policy="rr",
                    clock=clk)
    np.testing.assert_allclose(rs(np.ones((1, 2)), deadline_us=100.0), [2.0])


def test_least_slack_policy_picks_smallest_expected_completion():
    rs = ReplicaSet([lambda x: x, lambda x: x], policy="least_slack")
    rs.replicas[0].ewma_us, rs.replicas[0].inflight = 100.0, 1
    rs.replicas[1].ewma_us, rs.replicas[1].inflight = 300.0, 0
    picked = rs._pick()                  # (1+1)*100 = 200 < (0+1)*300
    assert picked.rid == 0
    rs.replicas[0].inflight -= 1


def test_replica_failover_marks_down_and_retries():
    down = {"n": 0}

    def bad(x):
        down["n"] += 1
        raise RuntimeError("replica crash")

    rs = ReplicaSet([bad, lambda x: x.sum(axis=-1)], policy="rr")
    np.testing.assert_allclose(rs(np.ones((2, 3))), [3.0, 3.0])
    assert down["n"] == 1
    rs(np.ones((1, 3)))                  # dead replica skipped, not retried
    assert down["n"] == 1
    stats = rs.stats()
    assert [r["healthy"] for r in stats] == [False, True]
    assert stats[1]["served"] == 2 and stats[0]["failures"] == 1


def test_all_replicas_down_raises_through_scheduler():
    def bad(x):
        raise RuntimeError("dead")

    rs = ReplicaSet([bad, bad])
    s = MicroBatchScheduler(rs, SchedConfig(max_batch=1), clock=FakeClock())
    f = s.submit(np.ones(2))
    s.poll()
    with pytest.raises(AllReplicasDown):
        f.result(0)


def test_least_loaded_prefers_idle_replica():
    rs = ReplicaSet([lambda x: x, lambda x: x], policy="least_loaded")
    rs.replicas[0].inflight = 3          # simulate a busy replica
    picked = rs._pick()
    assert picked.rid == 1
    rs.replicas[1].inflight -= 1


def test_replicaset_exec_seed():
    clk = FakeClock()

    def ex(x):
        clk.advance_us(40.0)
        return x.sum(axis=-1)

    rs = ReplicaSet([ex], policy="rr", clock=clk, exec_seed_us=300.0)
    st = rs.stats()[0]
    assert st["ewma_us"] == 300.0 and st["ewma_seeded"]
    rs(np.ones((1, 3), np.float32))
    assert rs.stats()[0]["ewma_us"] == pytest.approx(
        0.8 * 300.0 + 0.2 * 40.0)
    # unseeded: first real sample overwrites the zero cold-start
    rs2 = ReplicaSet([ex], policy="rr", clock=clk)
    rs2(np.ones((1, 3), np.float32))
    assert rs2.stats()[0]["ewma_us"] == pytest.approx(40.0)
    assert not rs2.stats()[0]["ewma_seeded"]


def test_unknown_policy_rejected():
    with pytest.raises(ValueError):
        ReplicaSet([lambda x: x], policy="random")


# ---------------------------------------------------------------------------
# The same dispatch scenarios in both packages
# ---------------------------------------------------------------------------

def _fleet(pkg, policy, n=3, seed_us=None, crash=(1, 3)):
    """n replicas whose service time differs (replica i takes 10·(i+1)
    µs of the fake clock); replica ``crash[0]`` raises on its call
    number ``crash[1]``."""
    serve = PKGS[pkg][1]
    clk = serve.FakeClock()
    calls = {i: 0 for i in range(n)}

    def make(i):
        def fn(x):
            calls[i] += 1
            clk.advance_us(10.0 * (i + 1))
            if (i, calls[i]) == crash:
                raise RuntimeError("replica crash")
            return x.sum(axis=-1) + i
        fn.n_features = 2
        return fn

    rs = serve.ReplicaSet([make(i) for i in range(n)], policy=policy,
                          clock=clk, exec_seed_us=seed_us)
    return clk, rs


@pytest.mark.parametrize("seed_us", [None, 25.0])
@pytest.mark.parametrize("policy", ["rr", "least_loaded", "least_slack"])
def test_dispatch_sequence_matches_reference(policy, seed_us):
    """Direct calls with held in-flight work: the replica each batch
    lands on (its result is offset by its id), failover, and stats."""
    trail = {}
    for pkg in PKGS:
        clk, rs = _fleet(pkg, policy, seed_us=seed_us)
        out = []
        for i in range(12):
            if i == 5:                   # a busy replica 0
                rs.replicas[0].inflight += 2
            if i == 9:
                rs.replicas[0].inflight -= 2
                rs.mark_up(1)
            if i == 10:
                rs.reseed_exec_estimate(15.0)
            out.append(float(rs(np.ones((1, 2)))[0]))
            out.append(rs.stats())
        assert rs.n_features == 2
        trail[pkg] = out
    assert trail["port"] == trail["ref"]


@pytest.mark.parametrize("late_us", [5.0, 11.0, 40.0])
def test_failover_restamp_matches_reference(late_us):
    """A batch whose deadline falls during the first replica's failure
    is rejected (not retried) in both packages; one that still has
    budget fails over."""
    got = {}
    for pkg, (obs, serve) in PKGS.items():
        clk, rs = _fleet(pkg, "rr", n=2)
        rs.replicas[0].fn = rs.replicas[1].fn          # both flaky
        out = []
        for i in range(6):
            try:
                out.append(float(rs(np.ones((1, 2)),
                                    deadline_us=clk.now_us() + late_us)[0]))
            except serve.RequestRejected as e:
                out.append(str(e.reason))
            except serve.AllReplicasDown:
                out.append("all down")
        got[pkg] = (out, rs.stats(), clk.now_us())
    assert got["port"] == got["ref"]


def _scheduled(pkg, policy):
    """A ReplicaSet behind a traced FakeClock scheduler, published into
    a registry; two SLO lanes."""
    obs, serve = PKGS[pkg]
    clk, rs = _fleet(pkg, policy, crash=(0, 2))
    tracer = obs.SpanTracer(clock=clk)
    s = serve.MicroBatchScheduler(
        rs, serve.SchedConfig(max_batch=2, n_priorities=2,
                              lane_slo_us=(45.0, 1000.0)),
        clock=clk, tracer=tracer)
    assert rs.tracer is tracer
    futs = []
    for i in range(10):
        futs.append(s.submit(np.full((1, 2), i, np.float32),
                             priority=i % 2))
        clk.advance_us(7.0)
        s.poll()
    s.drain()
    res = []
    for f in futs:
        try:
            res.append(float(f.result(0)[0]))
        except (serve.RequestRejected, serve.AllReplicasDown) as e:
            res.append(type(e).__name__)
    reg = obs.MetricsRegistry()
    rs.publish(reg)
    return (res, reg.snapshot(), s.metrics.snapshot(),
            [(e.ph, e.name, e.cat, e.ts_us, e.dur_us, e.scope_id, e.args)
             for e in tracer.events()])


@pytest.mark.parametrize("policy", ["rr", "least_loaded", "least_slack"])
def test_scheduled_replicas_match_reference(policy):
    port, ref = _scheduled("port", policy), _scheduled("ref", policy)
    assert port == ref
    names = {e[1] for e in port[3]}
    assert {"replica_dispatch", "replica_failover"} <= names
    assert port[1]["replicas"]["policy"] == policy


def test_set_tracer_reaches_replica_aggregators():
    class Agg:
        tracer = None

        def __call__(self, x):
            return x.sum(axis=-1)

        def set_tracer(self, tracer):
            self.tracer = tracer

    aggs = [Agg(), Agg()]
    rs = ReplicaSet(aggs + [lambda x: x])
    tracer = P.SpanTracer(clock=FakeClock())
    rs.set_tracer(tracer)
    assert rs.tracer is tracer and all(a.tracer is tracer for a in aggs)


# ---------------------------------------------------------------------------
# Engine replicas on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def demo_net():
    from repro_torch.configs.jsc import JSC_DEMO
    from repro_torch.models.mlp import final_masks, init_mlp, to_logic
    model = init_mlp(JSC_DEMO, torch.Generator().manual_seed(1))
    model.set_masks(final_masks(JSC_DEMO, model))
    return to_logic(JSC_DEMO, model)


@pytest.mark.parametrize("backend,engine", [("gather", None),
                                            ("lut_layer", None),
                                            ("bitplane", "cuda")])
def test_build_logic_replicas_serve_like_classify(demo_net, backend,
                                                  engine):
    from repro_torch.serving.engine import LogicEngine
    x = np.random.default_rng(2).normal(size=(150, 16)).astype(np.float32)
    want = LogicEngine(demo_net, 5, backend="gather",
                       device="cpu").classify(x)
    rs = PS.build_logic_replicas(demo_net, 5, n_replicas=2,
                                 backend=backend, max_batch=32,
                                 policy="least_slack", engine=engine,
                                 exec_seed_us=50.0, device="cpu")
    assert rs.n_features == 16 and len(rs.replicas) == 2
    assert all(r["ewma_seeded"] for r in rs.stats())
    s = MicroBatchScheduler(rs, SchedConfig(max_batch=32, max_wait_us=200.0))
    s.start()
    futs = [s.submit(x[i]) for i in range(x.shape[0])]
    s.stop(drain=True)
    got = np.array([int(f.result(timeout=30)) for f in futs])
    np.testing.assert_array_equal(got, want)
    assert sum(r["served"] for r in rs.stats()) == s.metrics.snapshot()[
        "n_batches"]


def test_build_logic_replicas_defaults_to_the_card(demo_net):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from repro_torch.device import NoCudaDeviceError
    with pytest.raises(NoCudaDeviceError):
        PS.build_logic_replicas(demo_net, 5, n_replicas=2)
