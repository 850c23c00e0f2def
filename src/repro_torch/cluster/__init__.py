"""Instance types the port prices (counterpart of ``repro.cluster``'s
catalog; the framework-free simulators stay in the reference)."""

from repro_torch.cluster.catalog import (
    G5_48XLARGE,
    H100,
    INSTANCE_TYPES,
    InstanceType,
    instance_type,
)

__all__ = ["G5_48XLARGE", "H100", "INSTANCE_TYPES", "InstanceType", "instance_type"]
