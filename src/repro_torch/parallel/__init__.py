"""Multi-device layout of the port: the reference's PartitionSpec rules
(``sharding``) and their DTensor placements."""
from . import sharding

__all__ = ["sharding"]
