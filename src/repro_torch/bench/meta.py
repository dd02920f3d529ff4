"""Run metadata stamped into the port's BENCH_*_torch.json records
(the torch copy of the reference's ``benchmarks/meta.py``).

A benchmark number without its provenance (commit, device, versions,
when it ran) cannot be compared across PRs with any confidence.
``bench_meta()`` collects that context; writers attach it as a
top-level ``meta`` block.
"""
from __future__ import annotations

import datetime
import os
import platform
import subprocess
from typing import Dict, Optional

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


def _git_sha() -> Optional[str]:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=REPO_ROOT, timeout=10,
            capture_output=True, text=True)
        return out.stdout.strip() or None if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError):
        return None


def bench_meta(seed: Optional[int] = None, device=None) -> Dict:
    """Provenance block for a benchmark JSON: git sha, UTC timestamp,
    python, torch and CUDA versions, the device the run used
    (``device_info``: backend, card name, power limit) and the number
    of cards, and the run seed (if any). Every field degrades to None
    rather than raising — metadata must never be the reason a
    benchmark run fails."""
    import torch

    from repro_torch.device import device_info

    meta: Dict = {
        "git_sha": _git_sha(),
        "timestamp_utc": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "python": platform.python_version(),
        "platform": platform.platform(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "n_devices": (torch.cuda.device_count()
                      if torch.cuda.is_available() else 0),
    }
    if seed is not None:
        meta["seed"] = int(seed)
    dev = torch.device("cpu" if device is None else device)
    meta.update(device_info(dev))
    return meta
