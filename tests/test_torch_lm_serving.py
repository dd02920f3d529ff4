"""The port's ``LMEngine`` and ``--mode lm`` against the reference's
engine on the same weights (carried across with
``weights.lm_params_from_jax``) and the same prompts: greedy tokens
identical at float32 and at the configs' bfloat16, for the dense, moe,
ssm and hybrid families; admission (priority lanes, deadline shedding,
backpressure) the same; the encoder-decoder family failing in both
engines; and the launcher and the example on the CPU.

The reference engine's jitted functions are compiled to round where the
program rounds (``xla_allow_excess_precision`` off, as in
tests/test_torch_lm.py): with XLA's default, bfloat16 logits move by a
few steps, and greedy tokens at a near tie follow them."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving.engine as ref_engine
from repro.configs import SMOKES as REF_SMOKES
from repro.models import lm as rlm
from repro.serve.clock import FakeClock as RefFakeClock
from repro.serve.sched import RequestRejected as RefRejected
from repro.serving.engine import LMEngine as RefEngine
from repro.serving.engine import LMRequest as RefRequest
from repro_torch.configs import SMOKES
from repro_torch.models import lm
from repro_torch.serve.clock import FakeClock
from repro_torch.serve.sched import RejectReason, RequestRejected
from repro_torch.serving.engine import LMEngine, LMRequest
from repro_torch.weights import lm_params_from_jax


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _StrictJax:
    """``jax`` for the reference engine, its ``jit`` compiled without
    excess precision."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fun, **kw):
        return jax.jit(fun, compiler_options={
            "xla_allow_excess_precision": False}, **kw)


@pytest.fixture(autouse=True)
def strict_reference(monkeypatch):
    monkeypatch.setattr(ref_engine, "jax", _StrictJax())


def carried(name, dtype):
    rcfg = dataclasses.replace(REF_SMOKES[name], compute_dtype=dtype)
    cfg = dataclasses.replace(SMOKES[name], compute_dtype=dtype)
    rp = rlm.init_params(rcfg, jax.random.PRNGKey(0))
    return rcfg, rp, cfg, lm_params_from_jax(cfg, jax.tree.map(np.asarray,
                                                              rp))


def order(reqs, done):
    """Each finished request's index in ``reqs`` (by identity)."""
    return [next(i for i, q in enumerate(reqs) if q is r) for r in done]


def prompts(cfg, n, seed=0, lengths=(16,)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, lengths[i % len(lengths)],
                         dtype=np.int32) for i in range(n)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["glm4-9b", "falcon-mamba-7b",
                                  "hymba-1.5b", "mixtral-8x22b"])
def test_engine_tokens_match_reference_engine(name, dtype):
    """5 requests through 2 slots (slot reuse, one admission mid-run),
    prompts of 12 and 20 tokens (hymba's past its 64-token window by the
    end of no request; the ring is held in test_torch_lm)."""
    rcfg, rp, cfg, p = carried(name, dtype)
    ps = prompts(cfg, 5, lengths=(12, 20))
    ref = RefEngine(rcfg, rp, n_slots=2, max_seq=48)
    rreqs = [RefRequest(prompt=q, max_new_tokens=3 + i % 3)
             for i, q in enumerate(ps)]
    rdone = ref.run(rreqs)
    eng = LMEngine(cfg, p, n_slots=2, max_seq=48, device="cpu")
    reqs = [LMRequest(prompt=q, max_new_tokens=3 + i % 3)
            for i, q in enumerate(ps)]
    done = eng.run(reqs)
    assert order(reqs, done) == order(rreqs, rdone)
    for r, rr in zip(reqs, rreqs):
        assert r.out_tokens == rr.out_tokens


def test_lm_engine_matches_single_request():
    """Twin of the reference's: continuous batching gives the tokens of a
    dedicated single-request greedy loop."""
    cfg = SMOKES["glm4-9b"]
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    ps = prompts(cfg, 3)

    def greedy(prompt, n_new):
        logits, cache = lm.prefill(cfg, params,
                                   torch.from_numpy(prompt[None]), max_seq=64)
        out = [int(torch.argmax(logits[0]))]
        pos = prompt.shape[0]
        for _ in range(n_new - 1):
            logits, cache = lm.decode_step(
                cfg, params, cache,
                torch.tensor([[out[-1]]], dtype=torch.int32),
                torch.tensor([pos], dtype=torch.int32))
            out.append(int(torch.argmax(logits[0])))
            pos += 1
        return out

    want = [greedy(q, 5) for q in ps]
    eng = LMEngine(cfg, params, n_slots=2, max_seq=64, device="cpu")
    reqs = [LMRequest(prompt=q, max_new_tokens=5) for q in ps]
    done = eng.run(reqs)
    got = {id(r): r.out_tokens for r in done}
    for r, w in zip(reqs, want):
        assert got[id(r)] == w
    # the engine cast the weights in place; the greedy loop on the cast
    # module gives the same tokens
    assert params.embed.dtype == torch.bfloat16
    assert [greedy(q, 5) for q in ps] == want


def test_lm_engine_slot_reuse():
    """Twin of the reference's: more requests than slots all complete."""
    cfg = SMOKES["falcon-mamba-7b"]
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    reqs = [LMRequest(prompt=rng.integers(0, cfg.vocab_size, 8,
                                          dtype=np.int32),
                      max_new_tokens=3) for _ in range(5)]
    done = LMEngine(cfg, params, n_slots=2, max_seq=32, device="cpu").run(reqs)
    assert len(done) == 5
    assert all(len(r.out_tokens) == 3 for r in done)


class _Ticking:
    """A clock that moves 10 µs at every read, for both packages."""

    def __init__(self, fake):
        self.fake = fake

    def now_us(self):
        self.fake.advance_us(10.0)
        return self.fake.now_us()


def test_admission_matches_reference_engine():
    """Priority lanes, deadline shedding and backpressure: the same
    requests finish in the same order with the same tokens, the same one
    is shed with DEADLINE_EXCEEDED, and a full queue rejects."""
    rcfg, rp, cfg, p = carried("glm4-9b", "float32")
    ps = prompts(cfg, 4, seed=3, lengths=(10,))
    lanes = (1, 0, 1, 0)
    budgets = (None, None, 25.0, None)
    outcome = {}
    for pkg, Engine, Request, Clock, Rejected in (
            ("ref", RefEngine, RefRequest, RefFakeClock, RefRejected),
            ("port", LMEngine, LMRequest, FakeClock, RequestRejected)):
        kw = {} if pkg == "ref" else {"device": "cpu"}
        eng = Engine(rcfg if pkg == "ref" else cfg, rp if pkg == "ref" else p,
                     n_slots=1, max_seq=32, max_pending=4,
                     clock=_Ticking(Clock()), **kw)
        reqs = [Request(prompt=q, max_new_tokens=2) for q in ps]
        futs = [eng.submit(r, priority=lane, deadline_us=b)
                for r, lane, b in zip(reqs, lanes, budgets)]
        with pytest.raises(Rejected) as full:
            eng.submit(Request(prompt=ps[0]))
        done = eng.run()
        shed = []
        for i, f in enumerate(futs):
            try:
                assert f.result() is reqs[i]
            except Rejected as e:
                shed.append((i, e.reason))
        outcome[pkg] = (order(reqs, done),
                        [r.out_tokens for r in done], shed,
                        full.value.reason)
    assert outcome["port"] == outcome["ref"]
    finished, _, shed, reason = outcome["port"]
    assert finished == [1, 3, 0]
    assert shed == [(2, RejectReason.DEADLINE_EXCEEDED)]
    assert reason == RejectReason.QUEUE_FULL


def test_short_prompt_conv_state_in_the_engine_follows_reference():
    """A one-token prompt on falcon-mamba: its one-row conv state fills
    the slot's three-row history in both engines (the same tokens); a
    two-token prompt cannot be spliced in either (ROADMAP, Reference
    caveats)."""
    rcfg, rp, cfg, p = carried("falcon-mamba-7b", "float32")
    one = [np.array([5], np.int32)]
    rdone = RefEngine(rcfg, rp, n_slots=1, max_seq=16).run(
        [RefRequest(prompt=one[0], max_new_tokens=4)])
    eng = LMEngine(cfg, p, n_slots=1, max_seq=16, device="cpu")
    done = eng.run([LMRequest(prompt=one[0], max_new_tokens=4)])
    assert done[0].out_tokens == rdone[0].out_tokens
    with pytest.raises(ValueError):
        RefEngine(rcfg, rp, n_slots=1, max_seq=16).run(
            [RefRequest(prompt=np.array([5, 6], np.int32))])
    with pytest.raises(RuntimeError):
        LMEngine(cfg, p, n_slots=1, max_seq=16, device="cpu").run(
            [LMRequest(prompt=np.array([5, 6], np.int32))])


def test_engine_fails_on_encdec_as_the_reference_does():
    """Both engines build an encoder-decoder model's pool (its
    ``enc_out`` leaf 0 frames long), and both fail at the first
    admission, whose prefill is given no ``enc_embeds``: the reference
    on an assert, the port with a ``ValueError`` naming them (ROADMAP,
    Reference caveats)."""
    rcfg, rp, cfg, p = carried("seamless-m4t-large-v2", "float32")
    ref = RefEngine(rcfg, rp, n_slots=2, max_seq=32)
    eng = LMEngine(cfg, p, n_slots=2, max_seq=32, device="cpu")
    assert sorted(eng.cache) == sorted(ref.cache)
    assert tuple(eng.cache["enc_out"].shape) == ref.cache["enc_out"].shape \
        == (2, 0, cfg.d_model)
    prompt = np.arange(1, 9, dtype=np.int32)
    with pytest.raises(AssertionError):
        ref.run([RefRequest(prompt=prompt)])
    with pytest.raises(ValueError, match="enc_embeds"):
        eng.run([LMRequest(prompt=prompt)])


@pytest.mark.parametrize("arch", ["glm4-9b", "mixtral-8x22b", "dbrx-132b"])
def test_launcher_mode_lm_on_the_cpu(capsys, arch):
    from repro_torch.launch.serve import main
    out = main(["--mode", "lm", "--arch", arch, "--smoke", "--device",
                "cpu", "--requests", "4", "--max-new", "8"])
    assert len(out["done"]) == 4 and out["tokens"] == 32
    assert all(len(r.out_tokens) == 8 and len(r.prompt) == 32
               for r in out["done"])
    assert out["launches"]["flash_attention"] == 0    # the CPU's twin
    assert out["device"]["backend"] == "cpu"
    printed = capsys.readouterr().out
    assert "32 tokens" in printed and "tok/s" in printed
    again = main(["--mode", "lm", "--arch", arch, "--smoke", "--device",
                  "cpu", "--requests", "4", "--max-new", "8"])
    assert ([r.out_tokens for r in again["done"]]
            == [r.out_tokens for r in out["done"]])


def test_example_serve_lm_on_the_cpu():
    from repro_torch.examples import serve_lm
    done = serve_lm.main(["--device", "cpu"])
    assert len(done) == 10 and all(len(r.out_tokens) == 12 for r in done)
