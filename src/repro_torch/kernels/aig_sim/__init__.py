from .ops import aig_sim, aig_sim_walk, compile_aig_tile_plan  # noqa: F401
from .ref import aig_sim_ref  # noqa: F401
