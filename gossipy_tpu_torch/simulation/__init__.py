"""The gossip simulation engine, its variants and its report."""

from .engine import GossipSimulator, Mailbox, SimState
from .nodes import CacheNeighGossipSimulator, PassThroughGossipSimulator, \
    PartitioningGossipSimulator, PENSGossipSimulator, \
    SamplingGossipSimulator, build_neighbor_table
from .report import SimulationReport
from .variants import All2AllGossipSimulator, TokenizedGossipSimulator, \
    TokenizedPartitioningGossipSimulator

__all__ = ["All2AllGossipSimulator", "CacheNeighGossipSimulator",
           "GossipSimulator", "Mailbox", "PENSGossipSimulator",
           "PartitioningGossipSimulator", "PassThroughGossipSimulator",
           "SamplingGossipSimulator", "SimState", "SimulationReport",
           "TokenizedGossipSimulator", "TokenizedPartitioningGossipSimulator",
           "build_neighbor_table"]
