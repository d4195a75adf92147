"""The gossip simulation engine, its variants, the sequential
high-fidelity engine, active-cohort rounds over a host pool, its events,
its scheduled faults and its report."""

from .cohort import CohortConfig, CohortPool, NominalTopology, PoolStore
from .engine import GossipSimulator, Mailbox, MemoryBudgetExceeded, \
    SimState
from .events import CallbackReceiver, JSONLinesReceiver, ProgressReceiver, \
    SimulationEventReceiver, SimulationEventSender
from .faults import ChaosConfig, ChurnProcess, FaultSchedule, FaultSpike, \
    OutageEpisode, PartitionEpisode, build_fault_schedule, \
    rounds_to_reconverge
from .nodes import CacheNeighGossipSimulator, PassThroughGossipSimulator, \
    PartitioningGossipSimulator, PENSGossipSimulator, \
    SamplingGossipSimulator, build_neighbor_table
from .report import SimulationReport
from .sequential import MessageRecord, SequentialGossipSimulator, SeqState
from .variants import All2AllGossipSimulator, TokenizedGossipSimulator, \
    TokenizedPartitioningGossipSimulator

__all__ = ["All2AllGossipSimulator", "CacheNeighGossipSimulator",
           "CallbackReceiver", "ChaosConfig", "ChurnProcess",
           "CohortConfig", "CohortPool",
           "FaultSchedule", "FaultSpike", "GossipSimulator",
           "JSONLinesReceiver", "Mailbox", "MemoryBudgetExceeded",
           "MessageRecord", "NominalTopology", "OutageEpisode",
           "PENSGossipSimulator", "PartitionEpisode",
           "PartitioningGossipSimulator", "PassThroughGossipSimulator",
           "PoolStore",
           "ProgressReceiver", "SamplingGossipSimulator",
           "SeqState", "SequentialGossipSimulator", "SimState",
           "SimulationEventReceiver", "SimulationEventSender",
           "SimulationReport", "TokenizedGossipSimulator",
           "TokenizedPartitioningGossipSimulator", "build_fault_schedule",
           "build_neighbor_table", "rounds_to_reconverge"]
