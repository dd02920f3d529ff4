"""A whole run at smoke size on the CPU, with the look for a card
skipped: a sound port comes out correct, each fault planted under the
timed path comes out not correct, the control (the reference in e4m3
in the port's place) reads well above the port, and the result line has
the contract's keys with the numbers compared last."""
import copy
import json

import pytest

from perfbench import checks, faults, harness, run as runmod
from perfbench.tests import smoke

SPEC = harness.benchmark_spec()
TRAIN = "glm4_9b.train_4k"
SERVE = ["nemotron_4_340b.decode_heavy", "nemotron_4_340b.prefill_heavy"]


def train_run(trace=False, **kw):
    r = smoke.make_run(TRAIN, smoke.GLM4_SMOKE, smoke.train_mix(),
                       seconds=0.5, trace=trace, **kw)
    return r, harness.kind_module("train").run(r)


def serve_run(cell, trace=False, whole_sample=False):
    mix = smoke.serve_mix(harness.find_cell(SPEC, cell)["traffic"])
    if whole_sample:
        mix["check_served_tokens"] = 10**6
    r = smoke.make_run(cell, smoke.NEMOTRON_SMOKE, mix, seconds=1.0,
                       trace=trace)
    return r, harness.kind_module("closed_serve").run(r)


def test_train_sound_run_is_correct(few_threads):
    _, out = train_run()
    assert out.correct, out.checks
    assert out.attempted >= 1 and out.failed == 0
    assert out.values["train_tokens_per_s"] > 0


@pytest.mark.parametrize("fault", [faults.state_unchanged, faults.half_batch],
                         ids=["state_unchanged", "half_batch"])
def test_train_fault_is_not_correct(fault, few_threads):
    with fault():
        _, out = train_run()
    assert not out.correct, out.checks


def test_state_unchanged_reads_one(few_threads):
    with faults.state_unchanged():
        _, out = train_run()
    got = {c.name: c.value for c in out.checks}
    assert got["train_grad_gap"] == pytest.approx(1.0)
    assert got["train_change_gap"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", SERVE)
def test_serve_sound_run_is_correct(cell, few_threads):
    _, out = serve_run(cell)
    assert out.correct, out.checks
    assert out.values["output_tokens_per_s"] > 0
    assert out.values["request_p95_ms"] > 0


@pytest.mark.parametrize("cell", SERVE)
def test_serve_token_altered_is_not_correct(cell, few_threads):
    with faults.token_altered(every=1):
        _, out = serve_run(cell, whole_sample=True)
    assert not out.correct, out.checks


def test_train_control_reads_above_the_port(few_threads):
    from perfbench.kinds import train
    r = smoke.make_run(TRAIN, smoke.GLM4_SMOKE, smoke.train_mix())
    trainer, feed = train.build(r)
    prog = train.first_steps(r, trainer, feed)
    ref = train.reference(r, prog["names"])
    port = checks.train_readings(prog, ref)
    control = checks.train_readings(train.reference(r, prog["names"],
                                                    "e4m3"), ref)
    assert max(control[k] / port[k] for k in port) >= 3, (port, control)


def test_serve_control_reads_above_the_port(few_threads):
    from perfbench.kinds import closed_serve
    cell = SERVE[0]
    mix = smoke.serve_mix()
    r = smoke.make_run(cell, smoke.NEMOTRON_SMOKE, mix, seconds=1.0)
    out = closed_serve.measure(r)
    port = closed_serve.reference_gaps(r, out.picked).max()
    control = closed_serve.reference_gaps(r, out.picked, "e4m3",
                                          against="float32").max()
    assert control >= 3 * port and control > 0


@pytest.mark.parametrize("cell,trace", [(TRAIN, 0), (TRAIN, 1), (SERVE[0], 1),
                                        (SERVE[1], 0)])
def test_result_line_keys(cell, trace, few_threads):
    r, out = (train_run(trace=bool(trace)) if cell == TRAIN
              else serve_run(cell, trace=bool(trace)))
    line = runmod.result_line(cell, SPEC, out, r, bool(trace))
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    json.loads(json.dumps(line))
    want = {m["name"] for m in harness.cell_metrics(
        SPEC, cell, "per_layer" if trace else "end_to_end")}
    assert set(line["metrics"]) <= want
    if not trace:
        assert set(line["metrics"]) == want
    else:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "busy_s" in line["device"] and "window_s" in line["device"]
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_no_card_exits_without_a_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = runmod.main(["--workload", TRAIN, "--seed", "1", "--seconds", "1",
                      "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_serve_sample_takes_one_request_a_slot(few_threads):
    _, out = serve_run(SERVE[0], whole_sample=True)
    slots = [d["slot"] for d in out.picked]
    assert None not in slots and len(slots) == len(set(slots)) >= 2


def test_sample_keeps_the_longest_and_skips_a_slot_already_taken():
    from perfbench.kinds import closed_serve
    done = [{"ok": True, "slot": i % 2, "prompt": [0] * p, "out": [1] * 4}
            for i, p in enumerate([3, 9, 5, 4])]
    mix = {"check_served_tokens": 100}
    picked = closed_serve.sample(done, mix, 11)
    assert picked[0] is done[1]                    # the longest first
    assert sorted(d["slot"] for d in picked) == [0, 1]
    assert len(closed_serve.sample(done, {"check_served_tokens": 4}, 11)) == 1
    assert len(closed_serve.sample(done, {"check_served_tokens": 4,
                                          "check_slots": 2}, 11)) == 2


@pytest.mark.parametrize("cell", [c["name"] for c in SPEC["workloads"]])
def test_recorded_readings_judged_at_the_cells_limits(cell):
    """Every calibration reading on the card, judged by the harness's own
    checks at the committed limits: the port correct on every seed, the
    control and each fault not correct on any."""
    from perfbench import calibrate
    body = harness.load_json(harness.HERE / "limits" / f"{cell}.json")
    by_seed = body["by_seed"]
    assert len(by_seed["program"]) >= 12 and len(by_seed["control"]) >= 3
    for role, seeds in by_seed.items():
        for seed, readings in seeds.items():
            verdict = calibrate.verdicts({role: readings}, body["limits"])
            assert verdict == {role: role == "program"}, (role, seed, readings)
