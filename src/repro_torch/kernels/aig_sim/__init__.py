from .ops import (aig_sim, aig_sim_walk, compile_aig_tile_plan,  # noqa: F401
                  max_sweeps, plan_walk)
from .ref import aig_sim_ref  # noqa: F401
