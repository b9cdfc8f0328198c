"""Fluid data generators (counterpart of ``nfs_tpu.sim``): the smoke
solver and the FLIP liquid solver that write the frames the stylizers
read."""

from nfs_tpu_torch.sim.flip import FlipSolver, liquid_sequence
from nfs_tpu_torch.sim.smoke import SmokeSolver, smoke_sequence

__all__ = ["SmokeSolver", "smoke_sequence", "FlipSolver", "liquid_sequence"]
