"""Build ``ServiceSpec`` objects from dicts, JSON or YAML: the port's own
copy of ``repro.service.loader``.

The loader is strict: unknown keys, wrong section types and out-of-range
values raise ``SpecError`` naming the field (a ``migration:`` section's own
checks included), as do an unknown policy, forecaster, model, instance
type or trace.  The top-level ``service:`` wrapper is optional.  YAML needs PyYAML, an
optional import; without it, JSON files and dicts still load.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping

from repro_torch.service.spec import (
    AutoscalerSpec,
    ForecastSpec,
    LatencySpec,
    MigrationSpec,
    ObservabilitySpec,
    PlacementFilter,
    ReplicaPolicySpec,
    ResourceSpec,
    ServiceSpec,
    ServingSpec,
    SimSpec,
    SLOBurnSpec,
    SLOSpec,
    SpecError,
    SweepSpec,
    WorkloadSpec,
)

try:  # optional dependency
    import yaml as _yaml
except ImportError:  # pragma: no cover - environment-dependent
    _yaml = None

__all__ = ["load_spec", "spec_from_dict", "spec_from_json", "spec_from_yaml"]


def _read_spec_file(path: str) -> str:
    try:
        with open(path) as f:
            return f.read()
    except OSError as e:
        raise SpecError(f"cannot read service spec file {path!r}: {e}") from e


def _section(d: Mapping[str, Any], key: str) -> Mapping[str, Any]:
    sub = d.get(key, {})
    if not isinstance(sub, Mapping):
        raise SpecError(f"section {key!r} must be a mapping, got "
                        f"{type(sub).__name__}")
    return sub


def _check_keys(d: Mapping[str, Any], allowed, where: str) -> None:
    unknown = set(d) - set(allowed)
    if unknown:
        raise SpecError(f"{where} has unknown keys {sorted(unknown)}; "
                        f"allowed: {sorted(allowed)}")


def _pick(d: Mapping[str, Any], cls, where: str) -> dict:
    """kwargs for a spec dataclass from a section dict, key-checked."""
    _check_keys(d, [f.name for f in dataclasses.fields(cls)], where)
    return dict(d)


def _nested(d: Mapping[str, Any], key: str, cls, where: str) -> dict:
    """``d``'s kwargs with the mapping at ``key`` built into ``cls``."""
    kw = dict(d)
    sub = kw.pop(key, None)
    if sub is not None:
        if not isinstance(sub, Mapping):
            raise SpecError(f"{where}.{key} must be a mapping, got "
                            f"{type(sub).__name__}")
        kw[key] = cls(**_pick(sub, cls, f"{where}.{key}"))
    return kw


def _resources_from_dict(d: Mapping[str, Any]) -> ResourceSpec:
    _check_keys(d, ("instance_type", "any_of", "exclude_zones"), "resources")
    kw: dict = {}
    if "instance_type" in d:
        kw["instance_type"] = d["instance_type"]
    if "exclude_zones" in d:
        kw["exclude_zones"] = tuple(d["exclude_zones"])
    any_of = d.get("any_of")
    if any_of is not None:
        if not isinstance(any_of, (list, tuple)):
            raise SpecError("resources.any_of must be a list of "
                            "{cloud|region|zone} filters")
        for e in any_of:
            if not isinstance(e, Mapping):
                raise SpecError(f"resources.any_of entries must be mappings, "
                                f"got {e!r}")
        kw["any_of"] = tuple(PlacementFilter.from_dict(e) for e in any_of)
    return ResourceSpec(**kw)


def _sweep_entry(entry: Any, cls, name_field: str, where: str):
    """A sweep policy / workload: a bare name or a full mapping."""
    if isinstance(entry, str):
        return cls(**{name_field: entry})
    if isinstance(entry, Mapping):
        return cls(**_pick(entry, cls, f"{where} entry"))
    raise SpecError(f"{where} entries must be names or mappings, got "
                    f"{entry!r}")


def _migration_from_dict(d: Mapping[str, Any], where: str) -> MigrationSpec:
    """A ``MigrationSpec``; its own ``ValueError``s (a bad compression mode,
    a negative threshold) become ``SpecError``s naming the section."""
    kw = _pick(d, MigrationSpec, where)
    try:
        return MigrationSpec(**kw)
    except SpecError:
        raise
    except ValueError as e:
        raise SpecError(f"{where}: {e}") from e


def _sweep_migration(entry: Any):
    """A sweep migration entry: a bool toggle or a full mapping."""
    if isinstance(entry, bool):
        return entry
    if isinstance(entry, Mapping):
        return _migration_from_dict(entry, "sweep.migration entry")
    raise SpecError(f"sweep.migration entries must be booleans or migration "
                    f"mappings, got {entry!r}")


def _sweep_from_dict(d: Mapping[str, Any]) -> SweepSpec:
    keys = [f.name for f in dataclasses.fields(SweepSpec)]
    _check_keys(d, keys, "sweep")
    for key in keys:
        if key in d and not isinstance(d[key], (list, tuple)):
            raise SpecError(f"sweep.{key} must be a list, got "
                            f"{type(d[key]).__name__}")
    for key in ("traces", "forecasters", "replica_models"):
        for v in d.get(key, ()):
            if not isinstance(v, str):
                raise SpecError(f"sweep.{key} entries must be strings, got "
                                f"{v!r}")
    return SweepSpec(
        policies=tuple(_sweep_entry(e, ReplicaPolicySpec, "name",
                                    "sweep.policies")
                       for e in d.get("policies", ())),
        traces=tuple(d.get("traces", ())),
        workloads=tuple(_sweep_entry(e, WorkloadSpec, "kind",
                                     "sweep.workloads")
                        for e in d.get("workloads", ())),
        seeds=tuple(d.get("seeds", ())),
        forecasters=tuple(d.get("forecasters", ())),
        replica_models=tuple(d.get("replica_models", ())),
        migration=tuple(_sweep_migration(e) for e in d.get("migration", ())),
    )


def _observability_from_dict(d: Mapping[str, Any]) -> ObservabilitySpec:
    """Build the observability section: detail / out_dir / jsonl /
    chrome_trace / window_s / trace_sample plus the nested ``slo_burn``
    mapping (target / fast_window_s / slow_window_s / fast_threshold /
    slow_threshold — see :class:`SLOBurnSpec`)."""
    return ObservabilitySpec(**_nested(
        _pick(d, ObservabilitySpec, "observability"), "slo_burn", SLOBurnSpec,
        "observability"))


def spec_from_dict(d: Mapping[str, Any]) -> ServiceSpec:
    """Build and validate a ``ServiceSpec`` from a plain dict."""
    if not isinstance(d, Mapping):
        raise SpecError(f"service spec must be a mapping, got "
                        f"{type(d).__name__}")
    if isinstance(d.get("service"), Mapping):
        d = d["service"]
    _check_keys(d, [f.name for f in dataclasses.fields(ServiceSpec)],
                "service spec")
    try:
        # only keys present are passed on: the dataclass defaults stay the
        # single source of truth
        kw: dict = {k: d[k] for k in ("name", "model", "trace",
                                      "load_balancer") if k in d}
        kw["resources"] = _resources_from_dict(_section(d, "resources"))
        for key, cls in (("replica_policy", ReplicaPolicySpec),
                         ("autoscaler", AutoscalerSpec),
                         ("workload", WorkloadSpec),
                         ("latency", LatencySpec)):
            kw[key] = cls(**_pick(_section(d, key), cls, key))
        if d.get("forecast") is not None:
            kw["forecast"] = ForecastSpec(
                **_pick(_section(d, "forecast"), ForecastSpec, "forecast"))
        if d.get("migration") is not None:
            kw["migration"] = _migration_from_dict(_section(d, "migration"),
                                                   "migration")
        serving = dict(_section(d, "serving"))
        # serving.replica_model is the reference's sugar for
        # sim.replica_model; a conflicting explicit sim value is an error
        serving_rm = serving.pop("replica_model", None)
        kw["serving"] = ServingSpec(**_nested(
            _pick(serving, ServingSpec, "serving"), "slo", SLOSpec, "serving"))
        if d.get("observability") is not None:
            kw["observability"] = _observability_from_dict(
                _section(d, "observability"))
        sim_kw = _pick(_section(d, "sim"), SimSpec, "sim")
        if serving_rm is not None:
            if sim_kw.get("replica_model", serving_rm) != serving_rm:
                raise SpecError(
                    f"serving.replica_model ({serving_rm!r}) conflicts with "
                    f"sim.replica_model ({sim_kw['replica_model']!r}); set one")
            sim_kw["replica_model"] = serving_rm
        kw["sim"] = SimSpec(**sim_kw)
        if d.get("sweep") is not None:
            kw["sweep"] = _sweep_from_dict(_section(d, "sweep"))
        spec = ServiceSpec(**kw)
    except TypeError as e:
        # e.g. a list where a scalar belongs
        raise SpecError(f"malformed service spec: {e}") from e
    return spec.validate()


def spec_from_json(path_or_text: str) -> ServiceSpec:
    """A spec from a JSON file path or a JSON document string."""
    text = path_or_text
    if not path_or_text.lstrip().startswith("{"):
        text = _read_spec_file(path_or_text)
    try:
        d = json.loads(text)
    except json.JSONDecodeError as e:
        raise SpecError(f"invalid JSON service spec: {e}") from e
    return spec_from_dict(d)


def spec_from_yaml(path_or_text: str) -> ServiceSpec:
    """A spec from a YAML file path or a YAML document string."""
    if _yaml is None:  # pragma: no cover - environment-dependent
        raise SpecError("PyYAML is not installed; use a JSON spec "
                        "(spec_from_json / a .json file)")
    text = path_or_text
    if "\n" not in path_or_text and not path_or_text.lstrip().startswith(
            ("{", "service:")):
        text = _read_spec_file(path_or_text)
    try:
        d = _yaml.safe_load(text)
    except _yaml.YAMLError as e:
        raise SpecError(f"invalid YAML service spec: {e}") from e
    if d is None:
        raise SpecError("empty YAML service spec")
    return spec_from_dict(d)


def load_spec(source: Any) -> ServiceSpec:
    """ServiceSpec | dict | path (.yaml / .yml / .json) -> a validated spec."""
    if isinstance(source, ServiceSpec):
        return source.validate()
    if isinstance(source, Mapping):
        return spec_from_dict(source)
    if isinstance(source, str):
        if source.endswith((".yaml", ".yml")):
            return spec_from_yaml(source)
        if source.endswith(".json"):
            return spec_from_json(source)
        raise SpecError(f"cannot infer spec format of {source!r}; expected a "
                        "dict, a ServiceSpec, or a path ending in "
                        ".yaml/.yml/.json")
    raise SpecError(f"cannot build a ServiceSpec from {type(source).__name__}")
