"""repro_torch.core against repro.core on the same numpy inputs:
quantizer forwards and level codes (every ActQuantSpec kind, inputs on
exact .5 rounding boundaries), BN folding, FCP masks, truth-table
extraction and LogicNetwork output codes — all exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as RQ
from repro.core.fcp import fanin_indices as ref_fanin_indices
from repro.core.fcp import topk_row_mask as ref_topk_row_mask
from repro.core.logic_infer import LogicNetwork as RefLogicNetwork
from repro.core.logic_infer import _bitexpand as ref_bitexpand
from repro.core.truthtable import extract_layer_tables as ref_extract
from repro.core.truthtable import onset_of as ref_onset_of
from repro_torch.core import quant as PQ
from repro_torch.core.fcp import fanin_indices, topk_row_mask
from repro_torch.core.logic_infer import LogicNetwork, _bitexpand
from repro_torch.core.truthtable import extract_layer_tables, onset_of

SPECS = [("sign", 1), ("binary", 1), ("pact", 2), ("pact", 3),
         ("signed", 1), ("signed", 2), ("signed", 3), ("none", 1)]


def _boundary_inputs(alpha):
    """Values whose scaled form lands on or next to x.5 for every spec
    above, plus the clip edges and random values."""
    rng = np.random.default_rng(0)
    vals = [0.0, -0.0, alpha, -alpha, 0.5 * alpha, -0.5 * alpha]
    for n in (1, 3, 7):                       # half / levels of the specs
        k = np.arange(-2 * n, 2 * n + 1)
        vals.extend(((k + 0.5) * alpha / n).tolist())
    x = np.asarray(vals, np.float32)
    x = np.concatenate([x, np.nextafter(x, np.float32(np.inf)),
                        np.nextafter(x, np.float32(-np.inf))])
    # the neighbours of 0 are subnormal: both packages code them as 0
    x = np.concatenate([x,
                        rng.normal(0, alpha, 200).astype(np.float32),
                        np.asarray([0.5, 1.5, 2.5, -1.5], np.float32)])
    return x.astype(np.float32)


@pytest.mark.parametrize("kind,bits", SPECS)
@pytest.mark.parametrize("alpha", [1.0, 0.75, 1.3])
def test_quantizer_forward_and_codes(kind, bits, alpha):
    x = _boundary_inputs(alpha)
    rs, ps = RQ.ActQuantSpec(kind, bits), PQ.ActQuantSpec(kind, bits)
    a32 = np.float32(alpha)
    want_q = np.asarray(RQ.apply_act_quant(rs, jnp.asarray(x),
                                           jnp.asarray(a32)))
    got_q = PQ.apply_act_quant(ps, torch.from_numpy(x), torch.tensor(a32))
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    if kind == "none":
        return
    assert ps.n_levels == rs.n_levels and ps.code_bits == rs.code_bits
    np.testing.assert_array_equal(ps.levels(alpha),
                                  np.asarray(rs.levels(alpha)))
    want_c = np.asarray(RQ.encode_levels(rs, jnp.asarray(want_q), alpha))
    got_c = PQ.encode_levels(ps, got_q, alpha)
    assert got_c.dtype == torch.int32
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    # codes straight from raw (unquantized) values too
    np.testing.assert_array_equal(
        PQ.encode_levels(ps, torch.from_numpy(x), alpha).numpy(),
        np.asarray(RQ.encode_levels(rs, jnp.asarray(x), alpha)))


def test_subnormal_inputs_keep_their_sign():
    """Subnormal inputs code as the reference codes them: its XLA CPU
    build flushes them to zero, and so does the port, on the CPU as on
    the card, so ``-1e-40`` quantizes like ``-0.0`` (to +1)."""
    tiny = np.float32(1e-40)
    x = np.asarray([-tiny, tiny, -0.0, 0.0], np.float32)
    for kind, bits in SPECS[:-1]:
        rs, ps = RQ.ActQuantSpec(kind, bits), PQ.ActQuantSpec(kind, bits)
        want_q = np.asarray(RQ.apply_act_quant(rs, jnp.asarray(x),
                                               jnp.float32(1.0)))
        got_q = PQ.apply_act_quant(ps, torch.from_numpy(x), 1.0)
        np.testing.assert_array_equal(got_q.numpy(), want_q)
        np.testing.assert_array_equal(
            PQ.encode_levels(ps, torch.from_numpy(x), 1.0).numpy(),
            np.asarray(RQ.encode_levels(rs, jnp.asarray(x), 1.0)))
    assert PQ.apply_act_quant(PQ.ActQuantSpec("sign", 1),
                              torch.from_numpy(x), 1.0).tolist() == [1.0] * 4


def test_select_activation_rule():
    for nonneg in (False, True):
        for bits in (1, 2, 3):
            r = RQ.select_activation(nonneg, bits)
            p = PQ.select_activation(nonneg, bits)
            assert (r.kind, r.bits) == (p.kind, p.bits)


def test_fold_bn():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(12, 9)).astype(np.float32)
    b, gamma, beta, mean = (rng.normal(size=12).astype(np.float32)
                            for _ in range(4))
    var = rng.uniform(0.1, 3.0, 12).astype(np.float32)
    rw, rb = RQ.fold_bn(*map(jnp.asarray, (w, b, gamma, beta, mean, var)))
    pw, pb = PQ.fold_bn(*map(torch.from_numpy, (w, b, gamma, beta, mean,
                                                 var)))
    np.testing.assert_array_equal(pw.numpy(), np.asarray(rw))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(rb))


def test_topk_row_mask_and_fanin_indices():
    rng = np.random.default_rng(2)
    w = rng.normal(size=(16, 20)).astype(np.float32)
    for fanin in (1, 3, 20, 25):
        want = np.asarray(ref_topk_row_mask(jnp.asarray(w), fanin))
        got = topk_row_mask(torch.from_numpy(w), fanin)
        np.testing.assert_array_equal(got.numpy(), want)
        ri, rv = ref_fanin_indices(want, 3)
        pi, pv = fanin_indices(want, 3)
        np.testing.assert_array_equal(pi, np.asarray(ri))
        np.testing.assert_array_equal(pv, np.asarray(rv))


def _layer_inputs(seed, n_in, n_out, fanin, short_rows=True):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n_out, n_in)).astype(np.float32)
    mask = np.array(ref_topk_row_mask(jnp.asarray(w), fanin))
    if short_rows:
        mask[0] = False                 # a row with no survivor
        mask[1, :] = False
        mask[1, 2] = True               # a row with fewer than fanin
    b = rng.normal(scale=0.3, size=n_out).astype(np.float32)
    bn = dict(gamma=rng.uniform(0.5, 1.5, n_out).astype(np.float32),
              beta=rng.normal(scale=0.2, size=n_out).astype(np.float32),
              bn_mean=rng.normal(scale=0.2, size=n_out).astype(np.float32),
              bn_var=rng.uniform(0.5, 2.0, n_out).astype(np.float32))
    return w, b, mask, bn


LAYERS = [
    # (in kind, in bits, out kind, out bits, in alpha, out alpha, fanin)
    ("signed", 2, "signed", 2, 1.0, 1.0, 3),
    ("signed", 2, "signed", 3, 0.8, 1.4, 3),
    ("sign", 1, "pact", 2, 1.0, 0.9, 4),
    ("binary", 1, "binary", 1, 1.0, 0.6, 4),
    ("pact", 2, "signed", 2, 1.1, 1.0, 2),
]


@pytest.mark.parametrize("layer", LAYERS)
@pytest.mark.parametrize("with_bn", [False, True])
def test_extract_layer_tables(layer, with_bn):
    ik, ib, ok, ob, ia, oa, fanin = layer
    w, b, mask, bn = _layer_inputs(3, 10, 8, fanin)
    kw = bn if with_bn else {}
    ref = ref_extract(jnp.asarray(w), jnp.asarray(b), mask,
                      RQ.ActQuantSpec(ik, ib), RQ.ActQuantSpec(ok, ob),
                      ia, oa, fanin, **{k: jnp.asarray(v)
                                        for k, v in kw.items()})
    got = extract_layer_tables(w, b, mask, PQ.ActQuantSpec(ik, ib),
                               PQ.ActQuantSpec(ok, ob), ia, oa, fanin, **kw)
    np.testing.assert_array_equal(got.fanin_idx, ref.fanin_idx)
    assert got.tables.dtype == ref.tables.dtype
    np.testing.assert_array_equal(got.tables, ref.tables)
    assert (got.in_alpha, got.out_alpha) == (ref.in_alpha, ref.out_alpha)
    for ob_ in range(got.out_spec.code_bits):
        for j in range(got.n_neurons):
            on = onset_of(got.tables[j], ob_)
            np.testing.assert_array_equal(on, ref_onset_of(ref.tables[j], ob_))
            for a, r in zip(_bitexpand(on, got, got.in_spec.code_bits),
                            ref_bitexpand(on, ref, ref.in_spec.code_bits)):
                if r is None:
                    assert a is None
                else:
                    np.testing.assert_array_equal(a, r)


def _networks():
    """A three-layer network built by both packages from the same
    weights: 12 inputs -> 10 -> 8 -> 5, signed codes."""
    rng = np.random.default_rng(4)
    specs = [("signed", 2), ("signed", 2), ("signed", 3)]
    widths, fanins, alphas = [12, 10, 8, 5], [3, 3, 3], [1.2, 0.9, 1.1]
    ref_layers, port_layers = [], []
    prev = ("signed", 2, 1.0)
    for i in range(3):
        w, b, mask, bn = _layer_inputs(10 + i, widths[i], widths[i + 1],
                                       fanins[i], short_rows=False)
        args = (RQ.ActQuantSpec(*prev[:2]), RQ.ActQuantSpec(*specs[i]),
                prev[2], alphas[i], fanins[i])
        ref_layers.append(ref_extract(
            jnp.asarray(w), jnp.asarray(b), mask, *args,
            **{k: jnp.asarray(v) for k, v in bn.items()}))
        port_layers.append(extract_layer_tables(
            w, b, mask, PQ.ActQuantSpec(*prev[:2]), PQ.ActQuantSpec(*specs[i]),
            prev[2], alphas[i], fanins[i], **bn))
        prev = (*specs[i], alphas[i])
    ref = RefLogicNetwork(ref_layers, RQ.ActQuantSpec("signed", 2), 1.0, 12, 5)
    port = LogicNetwork(port_layers, PQ.ActQuantSpec("signed", 2), 1.0, 12, 5)
    return ref, port


@pytest.mark.parametrize("use_kernel", [False, True])
def test_logic_network_codes(use_kernel):
    ref, port = _networks()
    x = np.random.default_rng(5).normal(size=(300, 12)).astype(np.float32)
    x[:6] = [[0.5] * 12, [-0.5] * 12, [1.5] * 12, [0.0] * 12, [1.0] * 12,
             [-1.0] * 12]                 # rounding boundaries and clips
    rcodes = np.asarray(ref.quantize_inputs(jnp.asarray(x)))
    pcodes = port.quantize_inputs(torch.from_numpy(x))
    np.testing.assert_array_equal(pcodes.numpy(), rcodes)
    np.testing.assert_array_equal(
        port.apply_codes(pcodes, use_kernel=use_kernel).numpy(),
        np.asarray(ref.apply_codes(jnp.asarray(rcodes))))
    np.testing.assert_array_equal(
        port(torch.from_numpy(x), use_kernel=use_kernel).numpy(),
        np.asarray(ref(jnp.asarray(x))))
