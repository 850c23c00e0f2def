"""Versioned step-time tables: the port's own copy of the on-disk contract
of ``repro.profiles`` (``repro.profiles.schema``).

A profile artifact is one JSON document under ``artifacts/profiles/``:

    {
      "schema_version": 1,
      "jax_version": "",
      "torch_version": "2.11.0+cu128",
      "device": "NVIDIA H100 80GB HBM3, 700.00 W",
      "backend": "cuda",
      "mode": "compiled",
      "entries": {
        "llama3.2-1b|H100": {
          "model": "llama3.2-1b",
          "accelerator": "H100",
          "backend": "cuda",
          "mode": "compiled",
          "jax_version": "",
          "torch_version": "2.11.0+cu128",
          "device": "NVIDIA H100 80GB HBM3, 700.00 W",
          "prefill_tokens": 256,
          ...
          "mfu_prefill": ...,
          "mbu_decode": ...
        },
        ...
      }
    }

The schema version, the field names, the key format ``"<model>|<accelerator>"``
and the load / merge / version gate are the reference's.  Two fields are
added, both defaulting to ``""``: ``torch_version`` and ``device`` (the
card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them; ``"cpu"`` for a CPU row).
``jax_version`` stays, empty.  The reference's ``ProfileEntry.from_dict``
ignores keys it does not know, so a table written here loads there
unchanged, and one written there loads here.

``mfu_prefill`` / ``mbu_decode`` are the measured kernel efficiencies
*relative to the target instance's peaks* (``peak_bf16_tflops`` ×
``hbm_bytes_per_s``): rows of backend ``cuda``, mode ``compiled`` are
measured on the card; rows of backend ``cpu``, mode ``eager`` ran the
kernels' plain versions on the CPU and validate the plumbing only.

``schema_version`` gates loading: a major-version bump means the field
contract changed and old readers must refuse rather than misprice runs.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Mapping, Optional

__all__ = [
    "SCHEMA_VERSION",
    "DEFAULT_PROFILE_DIR",
    "ProfileEntry",
    "ProfileTable",
    "ProfileSchemaError",
    "load_profiles",
]

SCHEMA_VERSION = 1
DEFAULT_PROFILE_DIR = os.path.join("artifacts", "profiles")


class ProfileSchemaError(ValueError):
    """A profile artifact is malformed or from an incompatible version."""


def _entry_key(model: str, accelerator: str) -> str:
    return f"{model}|{accelerator}"


@dataclasses.dataclass(frozen=True)
class ProfileEntry:
    """One measured (model × accelerator) step-time row."""

    model: str
    accelerator: str            # instance accelerator name, e.g. "H100"
    backend: str                # "cuda" | "cpu": where the measurement ran
    mode: str                   # "compiled" (the CUDA kernels) | "eager" (plain)
    # prompt length of the attention measurement; selective-scan kernels
    # are always timed over one chunk (the unit a model repeats across a
    # prompt), so for attention-free archs this is that chunk length
    prefill_tokens: int
    prefill_flops: float        # FLOPs issued by the timed prefill kernels
    prefill_wall_s: float
    decode_cache_tokens: int    # KV/state occupancy during decode steps
    decode_steps: int
    decode_bytes: float         # HBM bytes one decode step moves
    decode_wall_s: float        # wall seconds per decode step
    mfu_prefill: float          # achieved / instance peak FLOPs
    mbu_decode: float           # achieved / instance peak HBM bytes/s
    # per-entry provenance: tables merge across runs, so what measured
    # THIS row must not be inferred from table-level fields.  The port
    # leaves jax_version empty and fills the two fields after it.
    jax_version: str = ""
    torch_version: str = ""
    device: str = ""            # card name and power limit (nvidia-smi), or "cpu"

    @property
    def key(self) -> str:
        return _entry_key(self.model, self.accelerator)

    @property
    def prefill_flops_per_s(self) -> float:
        return self.prefill_flops / self.prefill_wall_s

    @property
    def decode_bytes_per_s(self) -> float:
        return self.decode_bytes / self.decode_wall_s

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "ProfileEntry":
        fields = dataclasses.fields(ProfileEntry)
        required = {
            f.name for f in fields if f.default is dataclasses.MISSING
        }
        missing = required - set(d)
        if missing:
            raise ProfileSchemaError(
                f"profile entry missing fields {sorted(missing)}"
            )
        names = {f.name for f in fields}
        return ProfileEntry(**{k: d[k] for k in names if k in d})


@dataclasses.dataclass
class ProfileTable:
    """A set of entries plus run-level provenance.

    Table-level ``jax_version``/``torch_version``/``device``/``backend``/
    ``mode`` describe the most recent run that wrote the file; tables merge
    across runs, so the authoritative provenance of each row is the entry's
    own fields.
    """

    jax_version: str = ""
    backend: str = ""
    mode: str = ""
    entries: Dict[str, ProfileEntry] = dataclasses.field(
        default_factory=dict
    )
    schema_version: int = SCHEMA_VERSION
    torch_version: str = ""
    device: str = ""

    def add(self, entry: ProfileEntry) -> None:
        self.entries[entry.key] = entry

    def lookup(
        self, model: str, accelerator: str
    ) -> Optional[ProfileEntry]:
        return self.entries.get(_entry_key(model, accelerator))

    def merge(self, other: "ProfileTable") -> None:
        """Later tables win on key collision (re-profiles supersede)."""
        self.entries.update(other.entries)

    # -- (de)serialization ---------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema_version": self.schema_version,
            "jax_version": self.jax_version,
            "torch_version": self.torch_version,
            "device": self.device,
            "backend": self.backend,
            "mode": self.mode,
            "entries": {
                k: e.to_dict() for k, e in sorted(self.entries.items())
            },
        }

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "ProfileTable":
        version = d.get("schema_version")
        if version != SCHEMA_VERSION:
            raise ProfileSchemaError(
                f"profile schema_version {version!r} is not the supported "
                f"{SCHEMA_VERSION}; re-generate the table with "
                "`python -m repro_torch.profiles.run`"
            )
        raw = d.get("entries", {})
        if not isinstance(raw, Mapping):
            raise ProfileSchemaError("profile 'entries' must be a mapping")
        table = ProfileTable(
            jax_version=str(d.get("jax_version", "")),
            backend=str(d.get("backend", "")),
            mode=str(d.get("mode", "")),
            torch_version=str(d.get("torch_version", "")),
            device=str(d.get("device", "")),
        )
        for key, ed in raw.items():
            entry = ProfileEntry.from_dict(ed)
            if entry.key != key:
                raise ProfileSchemaError(
                    f"profile entry keyed {key!r} describes {entry.key!r}"
                )
            table.add(entry)
        return table

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")

    @staticmethod
    def load(path: str) -> "ProfileTable":
        try:
            with open(path) as f:
                d = json.load(f)
        except OSError as e:
            raise ProfileSchemaError(
                f"cannot read profile table {path!r}: {e}"
            ) from e
        except json.JSONDecodeError as e:
            raise ProfileSchemaError(
                f"profile table {path!r} is not valid JSON: {e}"
            ) from e
        return ProfileTable.from_dict(d)


def load_profiles(path: str, *, missing_ok: bool = False) -> ProfileTable:
    """Load a profile table from a JSON file or a directory of them.

    Directory entries merge in sorted filename order (later files win on
    key collisions).  ``missing_ok`` returns an empty table for a path
    that does not exist — the serving layer's fallback-to-roofline path.
    """
    if not os.path.exists(path):
        if missing_ok:
            return ProfileTable()
        raise ProfileSchemaError(f"no profile table at {path!r}")
    if os.path.isdir(path):
        merged = ProfileTable()
        names = sorted(
            n for n in os.listdir(path) if n.endswith(".json")
        )
        for name in names:
            merged.merge(ProfileTable.load(os.path.join(path, name)))
        return merged
    return ProfileTable.load(path)
