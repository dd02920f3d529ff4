"""A process group of spawned processes on this host: the port's way to
run a placed path over several ranks without a launcher (the tests on
the CPU, ``chip_smoke.py`` on one card).

``run(fn, world, args)`` starts ``world`` processes (the ``spawn``
start method), joins them into one process group through a file store
in a temporary directory (no port is fixed, so runs side by side do not
collide), calls ``fn(*args)`` in each and returns the results by rank.
Each process uses ``threads`` intra-op threads and, with
``device="cuda"``, card ``rank % device_count`` (so every rank of a
world shares one card on a one-card machine). The backend is named by
the caller. A rank that raises, dies or is still running after
``timeout`` seconds fails the call: the others are stopped, and every
process is joined before ``run`` returns or raises. ``fn`` must be
importable by a fresh interpreter (a module-level function).
"""
from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence


def _rank_main(fn, rank: int, world: int, init: str, backend: str,
               device: str, threads: int, timeout: float, args, out):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(threads)
    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=init, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout))
        result = fn(*args)
        out.put((rank, True, result))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run(fn: Callable, world: int, args: Sequence[Any] = (), *,
        backend: str = "gloo", device: str = "cpu", threads: int = 1,
        timeout: float = 300.0) -> List[Any]:
    """``fn(*args)`` on every rank of a fresh ``world``-process group;
    the results, by rank. Raises ``RuntimeError`` with the first
    failing rank's traceback, or ``TimeoutError``."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    results, errors = {}, {}
    with tempfile.TemporaryDirectory() as d:
        init = "file://" + os.path.join(d, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            fn, r, world, init, backend, device, threads, timeout, args,
            out)) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(results) + len(errors) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{world} ranks of {getattr(fn, '__name__', fn)}: "
                        f"{len(results)} finished within {timeout:.0f} s")
                try:
                    rank, ok, payload = out.get(timeout=min(left, 1.0))
                except queue.Empty:
                    gone = [r for r, p in enumerate(procs)
                            if p.exitcode is not None
                            and r not in results and r not in errors]
                    if gone:
                        time.sleep(1.0)       # its last message may be late
                        if out.empty():
                            raise RuntimeError(
                                f"rank {gone[0]} exited with code "
                                f"{procs[gone[0]].exitcode} and no result")
                    continue
                (results if ok else errors)[rank] = payload
                if errors:
                    break
        finally:
            for p in procs:
                p.join(timeout=5 if errors or len(results) < world else 30)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        rank = min(errors)
        raise RuntimeError(f"rank {rank} of {world} failed:\n{errors[rank]}")
    return [results[r] for r in range(world)]
