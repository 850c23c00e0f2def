"""Multi-cloud substrate, the port's own copy of ``repro.cluster``: the
catalog, the spot traces, the instance FSM and the cluster simulator."""

from repro_torch.cluster.catalog import (
    G5_48XLARGE,
    H100,
    INSTANCE_TYPES,
    Catalog,
    CloudSpec,
    InstanceType,
    Zone,
    default_catalog,
    instance_type,
)
from repro_torch.cluster.instance import Instance, InstanceKind, InstanceState
from repro_torch.cluster.simulator import ClusterSimulator, SimConfig, SimResult
from repro_torch.cluster.traces import (
    SpotTrace,
    TraceLibrary,
    load_trace,
    synth_correlated_trace,
)

__all__ = [
    "G5_48XLARGE",
    "H100",
    "INSTANCE_TYPES",
    "Catalog",
    "CloudSpec",
    "InstanceType",
    "Zone",
    "default_catalog",
    "instance_type",
    "Instance",
    "InstanceKind",
    "InstanceState",
    "ClusterSimulator",
    "SimConfig",
    "SimResult",
    "SpotTrace",
    "TraceLibrary",
    "load_trace",
    "synth_correlated_trace",
]
