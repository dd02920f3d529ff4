"""Async checkpoints hold the state of the step they were taken at.

``AsyncCheckpointer.save`` copies the tree to host memory on the caller
thread and writes it on a worker thread. The next train step updates
the parameters and the AdamW moments in place, so the host copy must
be a copy, not a view of the live leaves (the reference's arrays are
immutable, and it copies them with ``device_get`` on the caller thread,
``repro/train/checkpoint.py``).

The race is made certain here: ``checkpoint._write`` is delayed until
the next step has run, and every committed step is held, bit for bit,
to a deep copy of the state taken right after that step. bf16 leaves
come from ``AdamW(mixed_precision=True)``, whose live parameters are
bf16 from the first update on and are then written in place.
"""
import copy
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.data.tokens import lm_batch
from repro_torch.dist import world
from repro_torch.models import lm
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import Trainer, init_state, make_train_step
from repro_torch.train.optim import AdamW

STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(cfg, batch=2, seq=64):
    t = 0
    while True:
        toks, labels = lm_batch(cfg, batch, seq, 0, t)
        t += 1
        yield {"tokens": torch.from_numpy(toks),
               "labels": torch.from_numpy(labels)}


def _state_tree(state):
    """The tree ``Trainer`` checkpoints, as flat key -> tensor."""
    return {k: v for k, v in ckpt._walk(state) if isinstance(v, torch.Tensor)}


@pytest.mark.parametrize("mixed", [False, True], ids=["float32", "bf16"])
def test_async_checkpoint_holds_its_own_step(tmp_path, monkeypatch, mixed):
    cfg = get_arch("phi4-mini-3.8b", smoke=True)
    opt = AdamW(lr=1e-3, mixed_precision=mixed)
    step = make_train_step(cfg, opt)
    snaps = {}

    def step_and_copy(state, batch):
        state, metrics = step(state, batch)
        snaps[int(state.opt.step)] = copy.deepcopy(_state_tree(state))
        return state, metrics

    real_write = ckpt._write
    stepped = {s: threading.Event() for s in range(1, STEPS + 2)}

    def late_write(ckpt_dir, step_no, flat, extra):
        # commit step s only once step s + 1 has changed the live state
        # (the last step waits for nothing: no step follows it)
        if step_no < STEPS:
            assert stepped[step_no + 1].wait(60)
        return real_write(ckpt_dir, step_no, flat, extra)

    def marking_step(state, batch):
        out = step_and_copy(state, batch)
        stepped[int(out[0].opt.step)].set()
        return out

    monkeypatch.setattr(ckpt, "_write", late_write)
    st = init_state(cfg, opt, torch.Generator().manual_seed(0))
    tr = Trainer(marking_step, st, ckpt_dir=str(tmp_path), ckpt_every=1,
                 keep=STEPS + 1)
    # the writer of step s waits on step s + 1, which the loop runs only
    # after save(s) returns: the save must not join its own writer first
    tr.run(_batches(cfg), STEPS, log_every=100, log_fn=lambda *_: None)
    assert sorted(ckpt._committed_steps(str(tmp_path))) == list(
        range(1, STEPS + 1))
    n_bf16 = 0
    for s in range(1, STEPS + 1):
        restored = ckpt.restore(str(tmp_path / f"step_{s:08d}"), tr.state)
        got = _state_tree(restored)
        want = snaps[s]
        assert set(got) == set(want)
        for key, w in want.items():
            assert got[key].dtype == w.dtype, (s, key)
            assert torch.equal(got[key], w.detach()), (s, key)
            n_bf16 += w.dtype == torch.bfloat16
    if mixed:
        assert n_bf16 == STEPS * len(lm.leaves(tr.state.params))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_host_copy_is_not_a_view(dtype):
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3).to(dtype)
    arr, _ = ckpt._host(t)
    before = arr.copy()
    t.add_(1)
    np.testing.assert_array_equal(arr, before)


def _placed_host_copy():
    """On a world of 1: a placed leaf's host copy, then the leaf changed
    in place; returns (host copy, its value before the change)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    leaf = distribute_tensor(torch.arange(8, dtype=torch.float32), mesh,
                             [Replicate(), Replicate()])
    arr, _ = ckpt._host(leaf)
    before = arr.copy()
    leaf.to_local().add_(1)
    return arr, before


def test_placed_host_copy_is_not_a_view():
    """``full_tensor()`` of a placed leaf at world 1 is the local shard
    itself: the host copy must not alias it."""
    (arr, before), = world.run(_placed_host_copy, 1, timeout=120.0)
    np.testing.assert_array_equal(arr, before)
