"""Request workloads of the port (counterpart of ``repro.workloads``):
the Poisson arrivals the scenario matrix runs on."""

from repro_torch.workloads.arrivals import (
    PoissonWorkload,
    Request,
    Workload,
    make_workload,
)

__all__ = ["PoissonWorkload", "Request", "Workload", "make_workload"]
