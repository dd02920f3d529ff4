"""Training cells: the port's ``Trainer`` over ``make_train_step`` (the
loss, every gradient by autograd through the flash backward, AdamW with
the launcher's warmup-cosine rate, decay and clip), fed the mix's rows.

Set-up builds one trainer from the seeded weights and drives it through
the first ``checked_steps`` steps with the window's own call and feed,
reading each step's loss, every leaf's first gradient (from AdamW's
first moment after step 1: mu = (1 - b1) g) and every leaf's change
after the last of them (against the leaf made again from the seed).
The same trainer then runs the window, one step a call, until
``seconds`` have passed at a step's end: tokens trained over the time
of those steps. Traced, ``trace_steps`` steps a third of the way in are
profiled, each inside a ``perfbench:train_step`` span. After the window
the trainer is freed and the reference follows the checked steps from
the same seed.
"""
from __future__ import annotations

import contextlib
import gc
import time

import torch

from perfbench import checks, harness, traffic, weights
from perfbench.reference import dense_decoder as ref


def _quiet(*_):
    pass


def build(r: harness.Run):
    """The trainer and its feed, from the seed: what the window runs."""
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import lm
    from repro_torch.train.loop import Trainer, init_state, make_train_step
    from repro_torch.train.optim import AdamW
    from repro_torch.train.schedules import warmup_cosine
    arch, o = r.config["arch"], r.traffic["optimizer"]
    cfg = ArchConfig(**arch)
    params = lm.Params(weights.nest(weights.make_all(
        arch, r.seed, torch.float32, r.device)))
    opt = AdamW(lr=warmup_cosine(o["lr"], o["warmup_steps"],
                                 o["total_steps"]),
                b1=o["b1"], b2=o["b2"], eps=o["eps"],
                weight_decay=o["weight_decay"], grad_clip=o["grad_clip"])
    trainer = Trainer(make_train_step(cfg, opt),
                      init_state(cfg, opt, params=params))
    feed = traffic.train_feed(r.traffic, r.seed, arch["vocab_size"],
                              r.device)
    return trainer, feed


def step(trainer, feed) -> float:
    """One step through the trainer, as the window takes it."""
    return trainer.run(feed, 1, log_every=1, log_fn=_quiet)["loss"]


def first_steps(r: harness.Run, trainer, feed) -> dict:
    """The checked steps, and the port's readings of them."""
    from repro_torch.models import lm
    arch, b1 = r.config["arch"], r.traffic["optimizer"]["b1"]
    specs = {n: (shape, scale) for n, shape, scale in weights.leaf_specs(arch)}
    names = lm.leaf_names(trainer.state.params)
    if sorted(names) != sorted(specs):
        raise RuntimeError(f"the port's leaves {names} are not the "
                           f"harness's {sorted(specs)}")
    prog = {"names": names, "losses": []}
    for i in range(int(r.traffic["checked_steps"])):
        prog["losses"].append(step(trainer, feed))
        if i == 0:
            prog["grad"] = {n: float(m.norm()) / (1 - b1) for n, m in
                            zip(names, trainer.state.opt.mu)}
    with torch.no_grad():
        prog["change"] = {
            n: float((p - weights.make_leaf(r.seed, n, *specs[n],
                                            torch.float32, r.device)).norm())
            for n, p in zip(names, lm.leaves(trainer.state.params))}
    return prog


def reference(r: harness.Run, names, products: str = "float32") -> dict:
    """The reference's checked steps from the seed."""
    arch, mix = r.config["arch"], r.traffic
    specs = {n: (shape, scale) for n, shape, scale in weights.leaf_specs(arch)}
    ref.tf32_off()
    batches = [traffic.train_batch(mix, r.seed, s, arch["vocab_size"],
                                   r.device)
               for s in range(1, int(mix["checked_steps"]) + 1)]
    return ref.train(arch, mix["optimizer"],
                     lambda n: weights.make_leaf(r.seed, n, *specs[n],
                                                 torch.float32, r.device),
                     names, batches, ref.Products(products))


def run(r: harness.Run) -> harness.Outcome:
    from repro_torch.kernels import launch_counts
    dev, mix = r.device, r.traffic
    tokens = int(mix["batch"]) * int(mix["seq"])
    harness.load_kernels(r)
    trainer, feed = build(r)
    r.phase("weights and trainer")
    prog = first_steps(r, trainer, feed)
    r.phase("checked steps")
    if r.trace:
        harness.warm_profiler(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_start = r.window_opens()
    trace_from = t_start + r.seconds / 3
    prof = sl = None
    steps = traced = 0
    while True:
        if r.trace and prof is None and time.perf_counter() >= trace_from:
            prof, counts0 = harness.profiler(dev), launch_counts()
            prof.start()
            tp0 = time.perf_counter()
        span = (torch.profiler.record_function(
            harness.span_name("train_step")) if prof is not None and sl is None
            else contextlib.nullcontext())
        with span:
            step(trainer, feed)
        steps += 1
        now = time.perf_counter()
        if prof is not None and sl is None:
            traced += 1
            if traced == int(mix["trace_steps"]) or now - t_start >= r.seconds:
                prof.stop()
                counts = {k: v - counts0[k] for k, v in launch_counts().items()}
                sl = (prof, now - tp0, counts)
        if now - t_start >= r.seconds:
            break
    elapsed = now - t_start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    r.log(f"{steps} steps in {elapsed:.3f} s; losses {prog['losses']}; "
          f"peak {peak} bytes")
    del trainer, feed
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref_out = reference(r, prog["names"])
    r.log(f"reference {time.perf_counter() - t_ref:.1f} s; losses "
          f"{ref_out['losses']}")
    out = harness.Outcome(
        values={"train_tokens_per_s": steps * tokens / elapsed,
                "setup_s": r.setup_s},
        checks=checks.train_checks(prog, ref_out, r.limits),
        attempted=steps, failed=0, memory_peak_bytes=peak)
    if sl is not None:
        out.slice = harness.read_profile(sl[0], sl[1], sl[2], r.config["arch"],
                                         mix, r.device_kind)
        r.log(f"traced slice: {traced} steps, "
              f"{1e3 * out.slice.window_s / traced:.3f} ms a step by the "
              f"trace ({1e3 * sl[1] / traced:.3f} by the host's clock; "
              f"window {1e3 * elapsed / steps:.3f})")
    return out
