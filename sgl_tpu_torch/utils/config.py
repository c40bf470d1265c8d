"""One dataclass config layer serving constructor-kwargs, CLI, and NAS roles.

The port's own copy of ``sgl_tpu/utils/config.py::TrainConfig`` (the port
imports nothing of ``sgl_tpu``); ``NodeClassification`` resolves its
defaults through it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, Dict, Optional


@dataclasses.dataclass
class TrainConfig:
    """Training-task configuration; usable as kwargs, from CLI, or JSON."""

    lr: float = 0.1
    weight_decay: float = 5e-5
    epochs: int = 200
    seed: int = 42
    train_batch_size: Optional[int] = None
    eval_batch_size: Optional[int] = None
    hidden_dim: int = 128
    num_layers: int = 2
    prop_steps: int = 3

    @classmethod
    def from_args(cls, argv=None, defaults: "TrainConfig" = None) -> "TrainConfig":
        """Parse ``--field value`` flags; ``defaults`` (e.g. a workload's
        shipped config) seeds every unspecified flag."""
        base = defaults or cls()
        parser = argparse.ArgumentParser()
        # field types are strings under `from __future__ import annotations`
        type_map = {"int": int, "float": float, "str": str}
        for f in dataclasses.fields(cls):
            t = type_map.get(str(f.type), int)  # Optional[int] etc. -> int
            parser.add_argument(f"--{f.name}", type=t, default=getattr(base, f.name))
        ns, _ = parser.parse_known_args(argv)
        return cls(**vars(ns))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_json(cls, s: str) -> "TrainConfig":
        return cls(**json.loads(s))

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)

    def resolve(self, **overrides) -> Dict[str, Any]:
        """Merge explicit (non-None) overrides over this config's fields."""
        out = {}
        for k, v in overrides.items():
            out[k] = v if v is not None else getattr(self, k)
        return out
