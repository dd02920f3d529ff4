"""The general generator: a seed repeats its traffic, two seeds differ
in order and ids but serve the same set of sizes."""
import numpy as np
import pytest
import torch

from perfbench import harness, traffic

SERVE_MIXES = ["closed_azure_conv", "closed_azure_code"]
BIG_SEED = 2**31 + 12345


@pytest.mark.parametrize("name", SERVE_MIXES)
def test_pool_repeats_under_one_seed(name):
    mix = harness.load_traffic(name)
    a, b = (traffic.RequestPool(mix, BIG_SEED, 1000) for _ in range(2))
    assert np.array_equal(a.prompt_len, b.prompt_len)
    assert np.array_equal(a.output_len, b.output_len)
    assert np.array_equal(a.prompt(5), b.prompt(5))


@pytest.mark.parametrize("name", SERVE_MIXES)
def test_pool_differs_under_two_seeds_with_the_same_sizes(name):
    mix = harness.load_traffic(name)
    a = traffic.RequestPool(mix, BIG_SEED, 1000)
    b = traffic.RequestPool(mix, BIG_SEED + 1, 1000)
    assert not np.array_equal(a.prompt_len, b.prompt_len)
    assert not np.array_equal(a.prompt(0)[:8], b.prompt(0)[:8])
    assert np.array_equal(np.sort(a.prompt_len), np.sort(b.prompt_len))


def test_pool_cycles_and_cuts_only_the_first_requests():
    mix = {"pool": 4, "clients": 3,
           "prompt_tokens": {"dist": "uniform", "min": 10, "max": 13},
           "output_tokens": {"dist": "uniform", "min": 20, "max": 23}}
    pool = traffic.RequestPool(mix, BIG_SEED, 100)
    taken = [pool.take() for _ in range(12)]
    assert [j for j, _ in taken] == [0, 1, 2, 3] * 3
    for i, (j, n) in enumerate(taken):
        if i < 3:
            assert 1 <= n <= pool.output_len[j]
        else:
            assert n == pool.output_len[j]
    assert sorted(pool.output_len) == [20, 21, 22, 23]


@pytest.mark.parametrize("name", SERVE_MIXES)
def test_lengths_within_the_mix(name):
    mix = harness.load_traffic(name)
    pool = traffic.RequestPool(mix, 3, 1000)
    assert pool.prompt_len.min() >= mix["prompt_tokens"]["min"]
    assert pool.prompt_len.max() <= mix["prompt_tokens"]["max"]
    assert pool.output_len.max() <= mix["output_tokens"]["max"]
    assert pool.output_len.min() >= 1
    assert (pool.prompt_len + pool.output_len).max() < mix["max_seq"]
    ids = pool.prompt(0)
    assert ids.dtype == np.int32 and 0 <= ids.min() and ids.max() < 1000


def test_quantile_lengths_hand_counts():
    u = traffic.quantile_lengths({"dist": "uniform", "min": 1, "max": 4}, 8)
    assert list(u) == [1, 1, 2, 2, 3, 3, 4, 4]
    lg = traffic.quantile_lengths({"dist": "loguniform", "min": 128,
                                   "max": 1024}, 3)
    assert list(lg) == [int(np.exp(np.log(128) + (i + .5) / 3 * (
        np.log(1025) - np.log(128)))) for i in range(3)]
    # median 100, mean 100 e^(1/2): sigma 1; the quantiles 1/6, 1/2, 5/6
    # lie at z = -0.9674, 0, 0.9674, the top one clipped at 200
    ln = traffic.quantile_lengths({"dist": "lognormal", "median": 100,
                                   "mean": 100 * np.exp(0.5), "min": 1,
                                   "max": 200}, 3)
    assert list(ln) == [38, 100, 200]


@pytest.mark.parametrize("name", SERVE_MIXES)
def test_lognormal_pool_keeps_the_source_median(name):
    mix = harness.load_traffic(name)
    pool = traffic.RequestPool(mix, 3, 1000)
    for key, lens in (("prompt_tokens", pool.prompt_len),
                      ("output_tokens", pool.output_len)):
        dist = mix[key]
        assert dist["dist"] == "lognormal"
        assert abs(np.median(lens) - dist["median"]) <= 1
        assert np.mean(lens) > dist["median"]        # the tail on the right


def test_train_batches_repeat_and_differ():
    mix = {"batch": 2, "seq": 16}
    cpu = torch.device("cpu")
    a = traffic.train_batch(mix, BIG_SEED, 1, 512, cpu)
    b = traffic.train_batch(mix, BIG_SEED, 1, 512, cpu)
    c = traffic.train_batch(mix, BIG_SEED, 2, 512, cpu)
    d = traffic.train_batch(mix, BIG_SEED + 1, 1, 512, cpu)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert not torch.equal(a["tokens"], d["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert not torch.equal(a["tokens"][0], a["tokens"][1])
