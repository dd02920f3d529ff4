"""repro_torch.dist.shardings against repro.dist.shardings: the rule
tables, in-process and without a process group. The twins of
tests/test_shardings.py's rule tests, then every leaf of the ten smoke
configs, ``_prune_spec``, ``_dp_for``, ``batch_axes`` under each
strategy flag, ``batch_shardings`` and ``cache_pspec`` for every cache
leaf of the dense, ssm, hybrid, MoE and encoder-decoder families, on
duck-typed meshes of shapes (16, 16), (2, 16, 16), (2, 4), (4, 2) and
(1, 1). The port's layers are unstacked, so its spec of a layer leaf is
the reference's without the leading (stacked) ``None``."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.dist.shardings as RSH
import repro.models.lm as RLM
from repro_torch.configs import get_arch
from repro_torch.dist import shardings as sh
from repro_torch.models import lm

ARCHS = sorted(RC.SMOKES)
MESHES = [(16, 16), (2, 16, 16), (2, 4), (4, 2), (1, 1)]
FLAGS = [{}, {"moe_ep": True}, {"fsdp_pure": True}, {"serve_tp_only": True},
         {"seq_parallel": True}, {"fsdp_pure": True, "seq_parallel": True}]
CACHE_ARCHS = ["glm4-9b", "falcon-mamba-7b", "hymba-1.5b", "mixtral-8x22b",
               "seamless-m4t-large-v2"]


def names_of(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def port_mesh(shape):
    return types.SimpleNamespace(mesh_dim_names=names_of(shape),
                                 shape=tuple(shape))


def ref_mesh(shape):
    names = names_of(shape)
    return type("M", (), {"axis_names": names,
                          "shape": dict(zip(names, shape))})()


@pytest.fixture
def ref_specs(monkeypatch):
    """The reference's sharding builders return their PartitionSpecs
    (a NamedSharding needs a real mesh of that many devices)."""
    monkeypatch.setattr(RSH, "NamedSharding", lambda mesh, spec: tuple(spec))


def ref_leaves(arch):
    cfg = RC.get_arch(arch, smoke=True)
    shapes = jax.eval_shape(lambda k: RLM.init_params(cfg, k),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    return {RSH._path_str(p): (p, leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}


def port_leaves(arch):
    return dict(lm.named_leaves(lm.init_params(
        get_arch(arch, smoke=True), torch.Generator().manual_seed(0))))


def ref_name(name):
    """``layers::3::attn::wq`` -> (``layers/attn/wq``, stacked)."""
    parts = name.split("::")
    if parts[0] in ("layers", "enc_layers"):
        return "/".join([parts[0]] + parts[2:]), True
    return "/".join(parts), False


# ---------------------------------------------------------------------------
# twins of tests/test_shardings.py
# ---------------------------------------------------------------------------

def test_param_pspec_rules():
    specs = {n: sh.param_pspec(n, t)
             for n, t in port_leaves("glm4-9b").items()}
    assert specs["embed"] == ("model", "data")
    assert specs["lm_head"] == ("data", "model")
    assert specs["layers::0::attn::wq"] == ("data", "model")
    assert specs["layers::1::attn::wo"] == ("model", "data")
    assert specs["layers::0::mlp::w1"] == ("data", "model")
    assert specs["layers::0::mlp::w2"] == ("model", "data")
    assert specs["layers::0::ln1"] == (None,)       # (d,) per-layer norm
    assert specs["final_norm"] == (None,)


def test_param_pspec_moe_and_mamba():
    for arch, (path, want) in [
        ("mixtral-8x22b", ("layers::0::moe::w1", (None, "data", "model"))),
        ("falcon-mamba-7b", ("layers::1::mamba::in_proj",
                             ("data", "model"))),
    ]:
        leaf = port_leaves(arch)[path]
        assert sh.param_pspec(path, leaf) == want, (arch, path)


def test_dp_for_divisibility():
    m = port_mesh((16, 16))
    assert sh._dp_for(m, 256) == "data"
    assert sh._dp_for(m, 1) is None
    assert sh._dp_for(m, 8) is None
    m2 = port_mesh((2, 16, 16))
    assert sh._dp_for(m2, 256) == ("pod", "data")
    assert sh._dp_for(m2, 2) == "pod"
    assert sh._dp_for(m2, 3) is None


# ---------------------------------------------------------------------------
# every leaf, every mesh, every flag
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspec_every_leaf_matches_reference(arch):
    ref = ref_leaves(arch)
    port = port_leaves(arch)
    seen = set()
    for name, t in port.items():
        rname, stacked = ref_name(name)
        path, leaf = ref[rname]
        want = tuple(RSH.param_pspec(path, leaf))
        assert sh.param_pspec(name, t) == (want[1:] if stacked else want), \
            name
        seen.add(rname)
    assert seen == set(ref)


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_prune_spec_and_params_shardings_match_reference(arch, shape,
                                                         ref_specs):
    ref = ref_leaves(arch)
    port = port_leaves(arch)
    pm, rm = port_mesh(shape), ref_mesh(shape)
    got = sh.params_shardings(pm, dict(port))
    for name, t in port.items():
        rname, stacked = ref_name(name)
        path, leaf = ref[rname]
        want = RSH._prune_spec(rm, leaf.shape,
                               tuple(RSH.param_pspec(path, leaf)))
        want = want[1:] if stacked else want
        assert sh._prune_spec(pm, tuple(t.shape),
                              sh.param_pspec(name, t)) == want, name
        assert got[name].spec == want and got[name].mesh is pm, name


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_dp_for_every_batch_matches_reference(shape):
    pm, rm = port_mesh(shape), ref_mesh(shape)
    for b in list(range(1, 65)) + [96, 128, 256, 512, 1024]:
        assert sh._dp_for(pm, b) == RSH._dp_for(rm, b), b


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: ",".join(f) or "none")
@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_batch_axes_under_each_flag_matches_reference(shape, flags):
    prev_p, prev_r = sh.set_opts(**flags), RSH.set_opts(**flags)
    try:
        assert sh.batch_axes() is None and RSH.batch_axes() is None
        with sh.use_mesh(port_mesh(shape)), RSH.use_mesh(ref_mesh(shape)):
            assert sh.batch_axes() == RSH.batch_axes()
            x = (8, 16, 32, 4)
            for spec in [(sh.batch_axes(), None, "model", None),
                         (("pod", "data"), "model", None, None),
                         ("model", "data", None, None)]:
                assert sh._prune_spec(port_mesh(shape), x, spec) == \
                    RSH._prune_spec(ref_mesh(shape), x, spec), spec
    finally:
        sh.set_opts(**prev_p)
        RSH.set_opts(**prev_r)


def test_set_opts_rejects_unknown_flags():
    with pytest.raises(KeyError):
        sh.set_opts(no_such_flag=True)
    assert sorted(sh.OPTS) == sorted(RSH.OPTS) == [
        "bf16_params", "fsdp_pure", "moe_ep", "seq_parallel",
        "serve_tp_only"]


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_batch_shardings_match_reference(shape, ref_specs):
    specs = {"tokens": np.zeros((256, 64), np.int32),
             "labels": np.zeros((8, 64), np.int32),
             "enc_embeds": np.zeros((32, 16, 8), np.float32),
             "scalar": np.zeros((), np.float32)}
    got = sh.batch_shardings(port_mesh(shape), specs)
    want = RSH.batch_shardings(ref_mesh(shape), {
        k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in specs.items()})
    assert {k: v.spec for k, v in got.items()} == want


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_pspec_every_leaf_matches_reference(arch, shape, ref_specs):
    cfg = get_arch(arch, smoke=True)
    frames = 16 if cfg.is_encdec else 0
    want = RSH.cache_pspec(ref_mesh(shape), jax.eval_shape(
        lambda: RLM.init_cache(RC.get_arch(arch, smoke=True), 32, 128,
                               frames)))
    cache = lm.init_cache(cfg, 32, 128, frames, device="meta")
    got = sh.cache_pspec(port_mesh(shape), cache)
    assert set(got) == set(want)
    for key, s in got.items():
        assert s.spec == want[key], key


def test_to_placements_and_spec_of_roundtrip():
    from torch.distributed.tensor import Replicate, Shard
    m = port_mesh((2, 4, 4))
    assert sh.to_placements(m, (("pod", "data"), "model")) == (
        Shard(0), Shard(0), Shard(1))
    assert sh.to_placements(m, (None, None)) == (Replicate(),) * 3
    fake = types.SimpleNamespace(device_mesh=m, ndim=3,
                                 placements=(Shard(0), Shard(0), Shard(2)))
    assert sh.spec_of(fake) == (("pod", "data"), None, "model")


def test_constraints_are_noops_off_mesh_and_on_plain_tensors():
    x = torch.ones(4, 8, 2, 16)
    assert sh.active_mesh() is None
    for fn in (sh.constrain_hidden, sh.constrain_heads, sh.constrain_logits):
        assert fn(x) is x
    assert sh.constraint(x, "data", None) is x
    assert sh.whole_heads(x, 2) is x
    with sh.use_mesh(port_mesh((2, 4))):
        assert sh.active_mesh() is not None
        for fn in (sh.constrain_hidden, sh.constrain_heads,
                   sh.constrain_logits):
            assert fn(x) is x
        with sh.suspend_mesh():
            assert sh.active_mesh() is None
    assert sh.active_mesh() is None


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_local_index_tiles_the_array(shape):
    """Every rank's block of a (pod, data) x model sharded array, from
    its mesh coordinate: the blocks tile the array exactly once."""
    names = names_of(shape)
    spec = (names[:-1] if len(names) == 3 else "data", "model")
    full = (64, 32)
    hits = np.zeros(full, np.int32)
    for coord in np.ndindex(*shape):
        m = types.SimpleNamespace(mesh_dim_names=names, shape=tuple(shape),
                                  get_coordinate=lambda c=coord: c)
        hits[sh.local_index(full, sh.Sharding(m, spec))] += 1
    assert (hits == 1).all()
