"""The gossip simulation engine and its report."""

from .engine import GossipSimulator, Mailbox, SimState
from .report import SimulationReport

__all__ = ["GossipSimulator", "Mailbox", "SimState", "SimulationReport"]
