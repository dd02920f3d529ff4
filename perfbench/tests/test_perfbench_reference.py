"""The plain reference against the port's CPU path at the smoke widths:
forward, loss, gradients, an AdamW step, and prefill and decode logits
through the cache. In float32 compute the two agree to rounding; the
benchmark's own comparison (bf16 port, float32 reference) is in
``test_perfbench_run``."""

import numpy as np
import pytest
import torch

from perfbench import traffic, weights
from perfbench.reference import dense_decoder as ref
from perfbench.tests.smoke import GLM4_SMOKE, NEMOTRON_SMOKE

ARCHES = [GLM4_SMOKE, NEMOTRON_SMOKE]
F32 = {"compute_dtype": "float32"}
SEED = 2**31 + 99


def port(arch):
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import lm
    cfg = ArchConfig(**arch)
    flat = weights.make_all(arch, SEED, torch.float32, "cpu")
    return cfg, lm.Params(weights.nest(flat)), flat


def batch(arch, b=2, s=24):
    return traffic.train_batch({"batch": b, "seq": s}, SEED, 1,
                               arch["vocab_size"], torch.device("cpu"))


@pytest.mark.parametrize("arch", ARCHES, ids=lambda a: a["name"])
def test_forward_and_loss(arch, few_threads):
    from repro_torch.models import lm
    arch = {**arch, **F32}
    cfg, params, flat = port(arch)
    bt = batch(arch)
    with torch.no_grad():
        hidden, _, _ = lm.forward(cfg, params, tokens=bt["tokens"])
        got = lm.logits_head(cfg, params, hidden)
        loss = lm.lm_loss(cfg, params, hidden, bt["labels"])
        s = bt["tokens"].shape[1]
        want = ref.logits_at(arch, flat.__getitem__,
                             [t.numpy() for t in bt["tokens"]],
                             [np.arange(s)] * 2, ref.Products(), "cpu")
        ref_loss = ref.loss(flat, arch, bt["tokens"], bt["labels"],
                            ref.Products())
    torch.testing.assert_close(got, torch.stack(want), atol=2e-4, rtol=1e-4)
    assert abs(float(loss) - float(ref_loss)) < 1e-5


@pytest.mark.parametrize("arch", ARCHES, ids=lambda a: a["name"])
def test_gradients(arch, few_threads):
    from repro_torch.models import lm
    from repro_torch.train.loop import loss_and_grads
    arch = {**arch, **F32}
    cfg, params, flat = port(arch)
    bt = batch(arch)
    _, grads = loss_and_grads(cfg, params, bt)
    names = lm.leaf_names(params)
    leaves = {n: t.clone().requires_grad_(True) for n, t in flat.items()}
    value = ref.loss(leaves, arch, bt["tokens"], bt["labels"],
                     ref.Products())
    want = torch.autograd.grad(value, [leaves[n] for n in names])
    for n, g, w in zip(names, grads, want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-4, msg=n)


@pytest.mark.parametrize("arch", ARCHES, ids=lambda a: a["name"])
def test_adamw_steps(arch, few_threads):
    """Three AdamW steps of the port's trainer against the reference's:
    losses, first gradients and changes of every leaf."""
    from perfbench import checks
    from perfbench.tests.smoke import make_run, train_mix
    from perfbench.kinds import train
    arch = {**arch, **F32}
    r = make_run("glm4_9b.train_4k", arch, train_mix(), seed=SEED)
    trainer, feed = train.build(r)
    prog = train.first_steps(r, trainer, feed)
    want = train.reference(r, prog["names"])
    readings = checks.train_readings(prog, want)
    assert readings["loss"] < 1e-6
    assert readings["grad"] < 1e-4
    assert readings["change"] < 1e-3


@pytest.mark.parametrize("arch", ARCHES, ids=lambda a: a["name"])
def test_prefill_and_decode_logits(arch, few_threads):
    from repro_torch.models import lm
    arch = {**arch, **F32}
    cfg, params, flat = port(arch)
    toks = batch(arch, 1, 20)["tokens"]
    p = 12
    got = []
    with torch.no_grad():
        logits, cache = lm.prefill(cfg, params, toks[:, :p], max_seq=32)
        got.append(logits[0])
        for t in range(p, toks.shape[1]):
            logits, cache = lm.decode_step(cfg, params, cache,
                                           toks[:, t:t + 1],
                                           torch.tensor([t]))
            got.append(logits[0])
        want = ref.logits_at(arch, flat.__getitem__, [toks[0].numpy()],
                             [np.arange(p - 1, toks.shape[1])],
                             ref.Products(), "cpu")[0]
    torch.testing.assert_close(torch.stack(got), want, atol=2e-4, rtol=1e-4)


def test_e4m3_products_round_to_float8():
    pr = ref.Products("e4m3")
    x = torch.linspace(-3, 3, 101)
    got = pr.round(x)
    scale = 3 / 448
    want = (x / scale).to(torch.float8_e4m3fn).float() * scale
    assert torch.equal(got, want)
    assert not torch.equal(got, x)
    with pytest.raises(ValueError):
        ref.Products("int4")


def test_weights_repeat_by_name_and_seed():
    a = weights.make_leaf(SEED, "layers::0::attn::wq", (8, 8), 0.5,
                          torch.bfloat16, "cpu")
    b = weights.make_leaf(SEED, "layers::0::attn::wq", (8, 8), 0.5,
                          torch.bfloat16, "cpu")
    c = weights.make_leaf(SEED, "layers::1::attn::wq", (8, 8), 0.5,
                          torch.bfloat16, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.dtype == torch.bfloat16
    tree = weights.nest({"embed": a, "layers::1::mlp::w1": c})
    assert tree["embed"] is a and tree["layers"][1]["mlp"]["w1"] is c
