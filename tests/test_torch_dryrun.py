"""The port's dry run (``repro_torch.launch.dryrun``) and its input specs
(``configs.input_specs``) against the reference's
``repro/launch/dryrun.py`` and ``repro/configs/base.py``.

The dry run counts rank 0's local work on fake tensors over a fake
process group. The counts are exact: integer FLOPs by
``torch.utils.flop_counter``'s formulas and integer bytes, so each is
held equal to its products or shards written out here. Every test that
starts a process group (fake or gloo) runs in a subprocess with its
own time limit, so no xdist worker keeps a group.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import input_specs as ref_input_specs
from repro_torch.configs import ARCHS, SHAPES, TensorSpec, get_arch, input_specs
from repro_torch.launch import dryrun

ROOT = pathlib.Path(__file__).resolve().parent.parent
SRC = ROOT / "src"


def run_py(code: str, timeout: float) -> dict:
    """``code`` in a fresh interpreter; the JSON object it prints last."""
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(SRC)}, capture_output=True,
        text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-6000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# input_specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_input_specs_match_reference(arch, shape):
    got = input_specs(ARCHS[arch], SHAPES[shape])
    want = ref_input_specs(REF_ARCHS[arch], REF_SHAPES[shape])
    assert list(got) == list(want)
    for name, spec in got.items():
        assert isinstance(spec, TensorSpec)
        assert spec.shape == tuple(want[name].shape), name
        assert str(spec.dtype).removeprefix("torch.") == \
            jnp.dtype(want[name].dtype).name, name


def test_importing_the_dry_run_starts_no_group():
    out = run_py("""
        import json, torch.distributed as dist
        import repro_torch.launch.dryrun, repro_torch.bench.roofline
        print(json.dumps({"group": dist.is_initialized()}))
    """, timeout=120)
    assert out == {"group": False}


# ---------------------------------------------------------------------------
# What is counted
# ---------------------------------------------------------------------------

def test_sharded_product_counts_local_work_once():
    """(256 x 4096) rows over 'data' times (4096 x 4096) columns over
    'model' on (data 16, model 16): rank 0's product is (16 x 4096) .
    (4096 x 256), 2 m n k = 33,554,432 FLOPs. A FlopCounterMode around
    the DTensor op counts the global product, 8,589,934,592; counting
    DTensor's sharding propagation as well would give 8,623,489,024.
    The first call (propagation run) and a second (propagation cached)
    count alike, and the product moves no collective."""
    out = run_py("""
        import json, torch
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from torch.utils.flop_counter import FlopCounterMode
        from repro_torch.launch import dryrun as D
        res = {}
        with D.fake_world(256):
            mesh = init_device_mesh("cpu", (16, 16),
                                    mesh_dim_names=("data", "model"))
            with D._fake_mode():
                a = DTensor.from_local(torch.randn(16, 4096), mesh,
                                       [Shard(0), Replicate()],
                                       run_check=False)
                b = DTensor.from_local(torch.randn(4096, 256), mesh,
                                       [Replicate(), Shard(1)],
                                       run_check=False)
                res["first"] = D.count_step(torch.mm, (a, b))
                res["second"] = D.count_step(torch.mm, (a, b))
                with FlopCounterMode(display=False) as fc:
                    torch.mm(a, b)
                res["flop_counter_mode"] = fc.get_total_flops()
        print(json.dumps(res))
    """, timeout=240)
    for key in ("first", "second"):
        assert out[key]["flops_per_device"] == 2 * 16 * 4096 * 256 \
            == 33_554_432
        assert out[key]["flops_by_shape"] == {
            "aten.mm [16, 4096] [4096, 256]": {"flops": 33_554_432.0,
                                                "calls": 1}}
        assert out[key]["collectives"]["total_bytes"] == 0
        assert out[key]["argument_size_in_bytes"] == (16 + 256) * 4096 * 4
        assert out[key]["output_size_in_bytes"] == 16 * 256 * 4
    assert out["flop_counter_mode"] == 2 * 256 * 4096 * 4096


def test_dense_smoke_train_step_counts_its_products():
    """One unplaced train step of phi4-mini's smoke (B 2, S 64) on fake
    tensors: each block runs forward, again in the backward (it is
    recomputed, as the reference's jax.checkpoint) up to its last
    product, w2, whose output the backward does not keep
    (torch.utils.checkpoint stops there), and its backward takes two
    products of each forward product (both operands need their
    gradient); the loss head runs forward and its two backward
    products. Nothing else is a product."""
    cfg = get_arch("phi4-mini-3.8b", smoke=True)
    b, s = 2, 64
    t = b * s
    d, h, kv, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    w2 = 2 * t * f * d
    layer = (2 * t * d * h * dh            # wq
             + 2 * 2 * t * d * kv * dh     # wk, wv
             + 2 * t * h * dh * d          # wo
             + 2 * 2 * t * d * f           # w1, w3
             + w2
             + 2 * 2 * b * h * s * s * dh)  # q k^T, p v
    head = 2 * t * d * cfg.padded_vocab
    from repro_torch.models import lm
    from repro_torch.train.loop import init_state, make_train_step
    from repro_torch.train.optim import AdamW
    with dryrun._fake_mode():
        opt = AdamW()
        state = init_state(cfg, opt, torch.Generator().manual_seed(0))
        batch = {"tokens": torch.zeros((b, s), dtype=torch.int32),
                 "labels": torch.zeros((b, s), dtype=torch.int32)}
        got = dryrun.count_step(make_train_step(cfg, opt), (state, batch))
        n_param = sum(p.numel() for p in lm.leaves(state.params))
    assert got["flops_per_device"] == \
        cfg.n_layers * (4 * layer - w2) + 3 * head == 124_780_544
    assert sum(v["flops"] for v in got["flops_by_shape"].values()) \
        == got["flops_per_device"]
    assert got["collectives"]["total_bytes"] == 0
    # parameters and both moments, float32, and the two int32 batches
    assert got["argument_size_in_bytes"] == 3 * 4 * n_param + 2 * 4 * t
    assert got["temp_size_in_bytes"] > 0


def test_collective_kinds():
    c10d = torch.ops.c10d
    func = torch.ops._c10d_functional
    ring = ([0, 0, 1, 0], [0, 1, 0, 0])
    assert dryrun.collective_kind(
        c10d.alltoall_base_.default, (None, None, None) + ring) == \
        "collective-permute"
    assert dryrun.collective_kind(
        func.all_to_all_single.default, (None, [2, 2], [2, 2], "g")) == \
        "all-to-all"
    assert dryrun.collective_kind(c10d.allreduce_.default, ()) == \
        "all-reduce"
    assert dryrun.collective_kind(
        func.all_gather_into_tensor.default, ()) == "all-gather"
    assert dryrun.collective_kind(
        func.reduce_scatter_tensor.default, ()) == "reduce-scatter"
    assert dryrun.collective_kind(func.wait_tensor.default, ()) is None
    with pytest.raises(ValueError):
        dryrun.collective_kind(c10d.broadcast_.default, ())


_WORLD8 = """
    import dataclasses, json, torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.dist import shardings as sh
    from repro_torch.launch import dryrun as D
    res = {}
    cells = [("glm4-9b", "train_4k", {}), ("glm4-9b", "train_4k",
             {"bf16_params": True}), ("glm4-9b", "prefill_32k", {}),
             ("hymba-1.5b", "decode_32k", {}),
             ("mixtral-8x22b", "decode_32k", {"moe_ep": True}),
             ("mixtral-8x22b", "decode_32k", {}),
             ("mixtral-8x22b", "train_4k", {})]
    with D.fake_world(8):
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        for arch, shape, opts in cells:
            cfg = get_arch(arch, smoke=True)
            shp = dataclasses.replace(SHAPES[shape], seq_len=64,
                                      global_batch=4)
            prev = sh.set_opts(**opts)
            with D._fake_mode(), sh.use_mesh(mesh):
                fn, args = D.build_cell(cfg, shp, mesh)
                want = D.rule_table_bytes(shp, mesh, args)
                whole = sum(D._nbytes(t) for t in D._leaves(args))
                got = D.count_step(fn, args)
            sh.set_opts(**prev)
            res[f"{arch} {shape} {sorted(opts)}"] = [
                got["argument_size_in_bytes"], want, whole,
                got["flops_per_device"]]
    print(json.dumps(res))
"""


def test_argument_bytes_are_the_rule_tables_local_shards_at_world_8():
    """At a fake world of 8, mesh (data 2, model 4), smoke configs: a
    cell's argument bytes, read from its arguments' local shards, equal
    the rule table's arithmetic from the global shapes, and are less
    than the whole arguments' bytes (the rule table shards something).
    The MoE cells run both ways: under ``moe_ep`` and under the rule
    table alone, decode and a training step."""
    out = run_py(_WORLD8, timeout=400)
    assert len(out) == 7
    for cell, (got, want, whole, flops) in out.items():
        assert got == want < whole, cell
        assert flops > 0, cell


def test_one_production_mesh_cell_end_to_end(tmp_path):
    """The entry point on one cell of the (16, 16) mesh, then the
    roofline over its record: ``ok``, 256 devices, the reference's keys,
    the extrapolated block equal to the direct count, and the argument
    bytes equal to the rule table's."""
    rc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "falcon-mamba-7b", "--shape", "decode_32k", "--mesh", "single",
         "--out", str(tmp_path)], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(SRC)}, capture_output=True,
        text=True, timeout=600)
    assert rc.returncode == 0, rc.stderr[-6000:]
    rec = json.loads(
        (tmp_path / "falcon-mamba-7b_decode_32k_single.json").read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    for key in ("flops_per_device", "bytes_accessed_per_device",
                "collectives", "params", "active_params",
                "argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "extrapolated"):
        assert key in rec, key
    assert set(rec["collectives"]["bytes"]) == set(dryrun.COLLECTIVES)
    assert rec["flops_per_device"] > 0
    assert rec["argument_size_in_bytes"] == rec["rule_table_argument_bytes"]
    ex = rec["extrapolated"]
    assert ex["flops_per_device"] == rec["flops_per_device"]
    assert ex["collective_bytes"] == rec["collectives"]["bytes"]
    assert ex["collective_total_bytes"] == rec["collectives"]["total_bytes"]
    assert ex["fit_points"] is None
    from repro_torch.bench import roofline
    (row,) = roofline.load_rows(str(tmp_path))
    assert row["arch"] == "falcon-mamba-7b" and row["t_compute_s"] > 0


def test_moe_cell_runs_the_rule_table_unless_asked():
    """mixtral-8x22b decode_32k at full width on the (16, 16) mesh with
    no options: ``ok`` under the rule table (the MoE block's
    ``moe_rule_table`` branch), and the record names no ``moe_ep``: the
    dry run takes the strategy its options name, as the reference's
    does."""
    out = run_py("""
        import json
        from repro_torch.dist import shardings as sh
        from repro_torch.launch import dryrun
        rec = dryrun.run_cell("mixtral-8x22b", "decode_32k", False)
        print(json.dumps({"status": rec["status"], "opts": rec["opts"],
                          "n_devices": rec["n_devices"],
                          "flops": rec["flops_per_device"],
                          "counts": dict(sh.COUNTS)}))
    """, timeout=300)
    assert out["status"] == "ok" and out["n_devices"] == 256
    assert "moe_ep" not in out["opts"]
    assert out["counts"].get("moe_rule_table", 0) > 0
    assert out["counts"].get("moe_expert_parallel", 0) == 0
    assert out["flops"] > 0


def test_long_context_full_attention_is_skipped():
    rec = dryrun.run_cell("glm4-9b", "long_500k", False)
    assert rec["status"] == "skipped"
    assert "500k" in rec["reason"]


def test_pipeline_dryrun_holds_one_stage_slab():
    """The pipeline twin at chameleon-34b's full width, cut to B 16, S
    256 and 4 microbatches: rank 0's argument bytes are its 3 layers
    (one stage's slab of 48 over 16 stages), the embedding, final norm
    and head whole, and the tokens; the ring shift counts as
    collective-permute, once a schedule step, and the closing sum as
    one all-reduce of the outputs."""
    out = run_py("""
        import json
        from repro_torch.examples import pipeline_dryrun
        print(json.dumps(pipeline_dryrun.run(batch=16, seq=256, n_micro=4)))
    """, timeout=400)
    cfg = ARCHS["chameleon-34b"]
    d, f, h, kv, dh = (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim)
    layer = (2 * d + d * h * dh + 2 * d * kv * dh + h * dh * d
             + (3 if cfg.act == "swiglu" else 2) * d * f)
    head = cfg.padded_vocab * d * (1 if cfg.tie_embeddings else 2) + d
    assert out["n_stages"] == 16 and out["layers_a_stage"] == 3
    assert out["slab_bytes"] == 4 * 3 * layer
    assert out["other_bytes"] == 4 * head
    assert out["tokens_bytes"] == 16 * 256 * 4
    assert out["argument_size_in_bytes"] == (
        out["slab_bytes"] + out["other_bytes"] + out["tokens_bytes"])
    steps = 4 + 16 - 1
    assert out["bubble"] == 15 / steps
    coll = out["collectives"]
    assert coll["counts"]["collective-permute"] == steps
    assert coll["bytes"]["collective-permute"] == steps * 4 * 256 * d * 2
    assert coll["counts"]["all-reduce"] == 1
    assert coll["bytes"]["all-reduce"] == 16 * 256 * d * 2
    assert out["flops_per_device"] > 0
