"""The port's launcher and batch placement over a process group on the
CPU (gloo, spawned worlds, ``repro_torch.dist.world``):

  * ``python -m repro_torch.launch.train --model-par 2`` in a world of 2
    against the unplaced launcher (no mesh flag) in this process;
  * ``mesh_placed`` / ``build_logic_replicas(mesh=)``: labels bit for bit
    those of the unplaced executor, each rank evaluating its rows;
  * ``sharded_batch``: each rank's block is its ``local_index`` of the
    host array, bit for bit, and the blocks make the array whole;
  * the mesh makers: the production meshes raise on a world of 1 and
    name the processes they need, the launcher's ``--production-mesh``
    too, and a model axis that does not divide the world raises.

The smoke configs compute in bfloat16, where a product split over ranks
rounds its partial sums (as the reference's sharded dots do): the
launcher's losses are held to the unplaced ones at the bf16 tolerance
of the LM parity tests, BF16_TOL x max(1, |x|).
"""
import numpy as np
import pytest
import torch

from repro_torch.dist import checks, world

BF16_TOL = 4 * 2.0 ** -7        # tests/test_torch_lm.py's
TIMEOUT = 180.0
ARGV = ["--arch", "glm4-9b", "--smoke", "--steps", "3", "--batch", "4",
        "--seq", "64", "--log-every", "1", "--device", "cpu"]
X = np.random.default_rng(2).normal(size=(150, 16)).astype(np.float32)
ARRAYS = {"tokens": np.arange(8 * 64, dtype=np.int32).reshape(8, 64),
          "frames": np.random.default_rng(3).normal(
              size=(6, 4, 16)).astype(np.float32),
          "odd": np.arange(7 * 3, dtype=np.int32).reshape(7, 3)}


@pytest.fixture(scope="module")
def two():
    jobs = [("launch", "launcher", {"argv": ARGV + ["--model-par", "2"]}),
            ("gather", "logic_labels", {"x_np": X, "backend": "gather",
                                        "shape": (2, 1), "device": "cpu"}),
            ("lut_layer", "logic_labels", {"x_np": X, "backend": "lut_layer",
                                           "shape": (2, 1),
                                           "device": "cpu"}),
            ("blocks", "batch_blocks", {"arrays": ARRAYS, "shape": (2, 1),
                                        "device": "cpu"}),
            ("meshes", "meshes", {"device": "cpu"})]
    return world.run(checks.run_checks, 2, (jobs,), timeout=TIMEOUT)


@pytest.fixture(scope="module")
def one():
    jobs = [("meshes", "meshes", {"device": "cpu"}),
            ("production", "launcher", {
                "argv": ARGV + ["--production-mesh"]}),
            ("multi_pod", "launcher", {
                "argv": ARGV + ["--production-mesh", "--multi-pod"]})]
    return world.run(checks.run_checks, 1, (jobs,), timeout=TIMEOUT)[0]


def ok(result):
    assert "error" not in result, result["error"]
    return result


def test_launcher_model_par_2_matches_unplaced(two):
    from repro_torch.launch.train import main
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = main(list(ARGV))
    finally:
        torch.set_num_threads(n)
    for rank in two:
        got = ok(rank["launch"])
        assert got["step"] == want["step"] == 3
        for key in ("loss", "grad_norm"):
            assert abs(got[key] - want[key]) <= BF16_TOL * max(
                1.0, abs(want[key])), (key, got[key], want[key])
    assert two[0]["launch"] == two[1]["launch"]


@pytest.mark.parametrize("backend", ["gather", "lut_layer"])
def test_mesh_placed_labels_bit_for_bit(two, backend):
    for rank in two:
        got = ok(rank[backend])
        assert got["n_features"] == 16
        assert got["placed"].shape == (150,)
        np.testing.assert_array_equal(got["placed"], got["unplaced"])


def test_mesh_placed_without_mesh_is_the_executor():
    from repro_torch.serve.replica import mesh_placed

    def fn(x):
        return x
    assert mesh_placed(fn, None) is fn


def test_sharded_batch_blocks(two):
    for key, arr in ARRAYS.items():
        seen = np.zeros(arr.shape[0], np.int32)
        for rank in two:
            got = ok(rank["blocks"])[key]
            np.testing.assert_array_equal(got["full"], arr)
            np.testing.assert_array_equal(got["local"], arr[got["index"]])
            seen[got["index"][0]] += 1
        # rows split where two divides them, else every rank holds all
        assert (seen == (1 if arr.shape[0] % 2 == 0 else 2)).all(), key


def test_mesh_makers_on_a_world_of_two(two):
    for rank in two:
        got = ok(rank["meshes"])
        assert got["production"].startswith("RuntimeError")
        assert "needs 256 processes" in got["production"]
        assert "world has 2" in got["production"]
        assert got["model_par_3"].startswith("ValueError")


def test_production_mesh_raises_on_a_world_of_one(one):
    got = ok(one["meshes"])
    assert "needs 256 processes" in got["production"], got
    assert "needs 512 processes" in got["multi_pod"], got
    assert "world has 1" in got["production"]
    assert got["model_par_3"].startswith("ValueError")
    for label, need in (("production", 256), ("multi_pod", 512)):
        err = one[label]["error"]
        assert "RuntimeError" in err and f"needs {need} processes" in err
