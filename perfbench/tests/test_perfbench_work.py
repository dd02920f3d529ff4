"""The frozen work arithmetic against hand counts at smoke widths, and
the metric readers on hand-made slices."""
import pytest

from perfbench import harness, work
from perfbench.tests.smoke import GLM4_SMOKE, NEMOTRON_SMOKE

PEAK = work.peak()


def test_params_hand_counts():
    # d 64, 4 heads of 16, 2 KV heads, FFN 160 (SwiGLU: 3 matrices)
    assert work.layer_matrix_params(GLM4_SMOKE) == (
        2 * 64 * 64 + 2 * 64 * 32 + 3 * 64 * 160)
    # squared ReLU: 2 matrices of 64 x 256
    assert work.layer_matrix_params(NEMOTRON_SMOKE) == (
        2 * 64 * 64 + 2 * 64 * 32 + 2 * 64 * 256)
    assert work.head_params(GLM4_SMOKE) == 64 * 512
    assert work.dims({**GLM4_SMOKE, "vocab_size": 500})["vp"] == 512


def test_pairs_and_flops_hand_counts():
    assert work.causal_pairs(4) == 10
    assert work.causal_pairs(2, 5) == 4 + 5
    layer, head = 43008, 32768
    assert work.train_model_flops(GLM4_SMOKE, 2, 4) == (
        6 * (2 * layer + head) * 8 + 3 * 2 * 4 * 16 * 4 * (2 * 10))
    assert work.prefill_flops(GLM4_SMOKE, 4) == (
        2 * 2 * layer * 4 + 2 * 4 * 16 * 4 * 10 + 2 * head)
    assert work.decode_flops(GLM4_SMOKE, 3, 30) == (
        2 * (2 * layer + head) * 3 + 2 * 4 * 16 * 4 * 30)


def test_bytes_hand_counts():
    layer, head = 43008, 32768
    # weights in bf16, 5 norm scales in float32, 4 embedding rows, the
    # 30 cached-or-new tokens' K and V (2 layers x 2 x 2 KV heads x 16 x 2
    # bytes), 4 slots' logits in bf16
    assert work.decode_bytes(GLM4_SMOKE, 3, 30, 4) == (
        (2 * layer + head) * 2 + 5 * 64 * 4 + 4 * 64 * 2
        + 30 * 2 * 2 * 2 * 16 * 2 + 4 * 512 * 2)
    f, b = work.flash_forward_work(2, 4, 4, 4, 2, 16, True)
    assert f == 4 * 16 * 4 * 2 * 10
    assert b == 2 * (2 * 2 * 4 * 4 * 16 + 2 * 2 * 4 * 2 * 16) + 4 * 2 * 4 * 4
    f, b = work.flash_backward_work(2, 4, 4, 4, 2, 16)
    assert f == 10 * 16 * 4 * 2 * 10
    q, kv = 2 * 4 * 4 * 16, 2 * 4 * 2 * 16
    assert b == 2 * (4 * q + 4 * kv) + 4 * 2 * 4 * 4


def test_bound_is_the_longer_of_the_two():
    assert work.bound_s(989e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert work.bound_s(989e12, 6.7e12) == pytest.approx(2.0)


def _slice(ops, spans, counts=None, wall=1.0, traffic=None):
    return harness.Slice(wall, ops, spans, counts or {}, GLM4_SMOKE,
                         traffic or {"batch": 2, "seq": 4}, [])


def _op(name, t0, t1, span=None):
    return harness.DeviceOp(name, int(t0 * 1e9), int(t1 * 1e9), span)


def test_readers_on_a_hand_made_slice():
    ops = [_op("gemm", 0.0, 0.2, "prefill"), _op("flash_fwd", 0.1, 0.3,
                                                 "prefill"),
           _op("gemm", 0.5, 0.6, "decode")]
    spans = [harness.Span("prefill", {"S": 4.0}, 0, 1),
             harness.Span("decode", {"active": 3.0, "ctx": 30.0,
                                     "slots": 4.0}, 2, 3)]
    s = _slice(ops, spans)
    assert s.busy_s == pytest.approx(0.4)
    assert s.window_s == pytest.approx(0.6)      # the trace's, not wall
    read = harness.metric_reader
    assert read("serve_idle_share")(s) == pytest.approx(100 * (1 - 0.4 / 0.6))
    assert read("engine_prefill_share")(s) == pytest.approx(
        100 * 0.4 / 0.5)
    assert read("serve_mfu")(s) == pytest.approx(100 * (
        work.prefill_flops(GLM4_SMOKE, 4)
        + work.decode_flops(GLM4_SMOKE, 3, 30)) / (0.6 * PEAK["bf16_flops"]))
    bound = work.bound_s(work.decode_flops(GLM4_SMOKE, 3, 30),
                         work.decode_bytes(GLM4_SMOKE, 3, 30, 4))
    assert read("decode_roofline")(s) == pytest.approx(100 * bound / 0.1)
    fb = 2 * work.bound_s(*work.flash_forward_work(1, 4, 4, 4, 2, 16, False))
    assert read("flash_roofline.prefill")(s) == pytest.approx(100 * fb / 0.2)


def test_training_readers_on_a_hand_made_slice():
    ops = [_op("flash_attention_kernel", 0.0, 0.1),
           _op("flash_bwd_wgmma_kernel", 0.2, 0.25), _op("gemm", 0.3, 0.5)]
    s = _slice(ops, [harness.Span("train_step", {}, 0, 1)] * 2,
               {"flash_attention": 4, "flash_attention_backward": 2}, 2.0)
    read = harness.metric_reader
    shape = (2, 4, 4, 4, 2, 16)
    bound = (4 * work.bound_s(*work.flash_forward_work(*shape, True))
             + 2 * work.bound_s(*work.flash_backward_work(*shape)))
    assert read("flash_roofline.train")(s) == pytest.approx(
        100 * bound / 0.15)
    assert read("train_mfu")(s) == pytest.approx(
        100 * 2 * work.train_model_flops(GLM4_SMOKE, 2, 4)
        / (0.5 * PEAK["bf16_flops"]))
    assert read("train_idle_share")(s) == pytest.approx(
        100 * (1 - 0.35 / 0.5))


@pytest.mark.parametrize("name", [m["name"] for m in
                                  harness.benchmark_spec()["per_layer"]])
def test_readers_return_nothing_on_an_empty_slice(name):
    assert harness.metric_reader(name)(_slice([], [])) is None
