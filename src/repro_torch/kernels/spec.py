"""One launch-configuration surface for every kernel in
``repro_torch.kernels``.

  * ``TileConfig`` — the geometry knobs: word tile per thread block
    (``block_w``), slot tile for the streamed netlist walk
    (``tile_rows``, baked into the ``TilePlan``), and the shared-memory
    budget one block may use;
  * ``KernelSpec`` — the launch configuration one wrapper takes.

Where a kernel runs is not part of the spec: it is the device of the
tensors the wrapper is given (the plain torch version on the CPU, the
CUDA kernel on a CUDA tensor).
"""
from __future__ import annotations

import dataclasses

DEFAULT_BLOCK_W = 32        # packed words per thread block
DEFAULT_TILE_ROWS = 32      # slot tile for streamed netlist walks
# the shared memory one thread block can use on an H100 (227 KB of the
# SM's 256 KB; above 48 KB only as opted-in dynamic shared memory)
DEFAULT_SMEM_BUDGET = 232_448


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Geometry of one kernel launch.

    ``block_w`` tiles the packed-word axis (one thread block per word
    tile; an upper bound, clamped to the problem and to
    ``smem_budget_bytes``), and ``tile_rows`` is the slot tile of the
    streamed netlist walk.
    """

    block_w: int = DEFAULT_BLOCK_W
    tile_rows: int = DEFAULT_TILE_ROWS
    smem_budget_bytes: int = DEFAULT_SMEM_BUDGET

    def clamp_block_w(self, w: int) -> int:
        """Effective word tile for a ``w``-word problem."""
        return min(self.block_w, max(1, w))


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """A sweepable launch configuration for one kernel."""

    tile: TileConfig = dataclasses.field(default_factory=TileConfig)

    def with_tile(self, **kw) -> "KernelSpec":
        """Copy with tile-geometry fields replaced (sweep helper)."""
        return dataclasses.replace(
            self, tile=dataclasses.replace(self.tile, **kw))


DEFAULT_SPEC = KernelSpec()
