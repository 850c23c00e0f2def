"""Request workloads of the port (counterpart of ``repro.workloads``):
Poisson, Arena-like bursty and MAF-like diurnal arrivals."""

from repro_torch.workloads.arrivals import (
    ArenaWorkload,
    MAFWorkload,
    PoissonWorkload,
    Request,
    Workload,
    interarrival_stats,
    make_workload,
)

__all__ = ["ArenaWorkload", "MAFWorkload", "PoissonWorkload", "Request",
           "Workload", "interarrival_stats", "make_workload"]
