"""The placed paths in a world of 8 at the reference's shapes: the
checks of tests/test_torch_dist.py on tests/dist_check.py's mesh (data
2, model 4), in one spawned gloo world of 8 processes on the CPU.

At this shape the model axis of 4 runs beside a data axis of 2, which
the world of 4 never does: the expert-parallel MoE over 4 model ranks,
fsdp_pure over all 8, the sequence-sharded decode (KV 2 on a model axis
of 4), the elastic restore from (2, 4) onto (4, 2), and GPipe's 4
stages beside data parallelism, with every layer on every rank and
with each rank holding only its stage's layer. The tolerances and the
reference's results are tests/test_torch_dist.py's.
"""
import pytest

from repro_torch.dist import checks, world
from test_torch_dist import (build, hold_decode, hold_elastic, hold_fsdp,
                             hold_mixed_precision, hold_moe, hold_pipeline,
                             hold_pipeline_stages, hold_same_results, result)

WORLD = 8
TIMEOUT = 300.0
MESHES = {"moe": (2, 4), "fsdp": (2, 4),
          "decode": {"decode_sequence": (2, 4)},
          "elastic": ((2, 4), (4, 2)), "pipeline": (2, 4)}


@pytest.fixture(scope="module")
def run8(tmp_path_factory):
    jobs, ref = build(tmp_path_factory, MESHES)
    ranks = world.run(checks.run_checks, WORLD, (jobs,), timeout=TIMEOUT)
    return ref, ranks


def test_every_rank_returns_the_same_results(run8):
    hold_same_results(run8[1])


def test_moe_expert_parallel(run8):
    hold_moe(*result(run8, "moe"))


def test_moe_rule_table(run8):
    hold_moe(*result(run8, "moe_rule_table"), branch="moe_rule_table")


def test_fsdp_pure_train_step(run8):
    hold_fsdp(*result(run8, "fsdp"))


def test_mixed_precision_placed_steps(run8):
    hold_mixed_precision(result(run8, "mixed")[1])


def test_decode_serve_tp_only(run8):
    """KV 2 does not divide the model axis of 4: the cache and the
    attention shard the sequence."""
    hold_decode(*result(run8, "decode_sequence"), "decode_sequence",
                (None, "data", "model", None, None))


def test_elastic_restore_onto_another_mesh(run8):
    hold_elastic(result(run8, "elastic")[1], (4, 2))


def test_pipeline_forward_and_gradient(run8):
    hold_pipeline(*result(run8, "pipeline"))


def test_pipeline_placed_by_stage(run8):
    """Ranks (d, s) of the (2, 4) mesh: stage s holds layer s, on both
    data rows."""
    hold_pipeline_stages(*run8, [[0], [1], [2], [3]] * 2)
