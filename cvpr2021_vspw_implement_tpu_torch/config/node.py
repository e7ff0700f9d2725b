"""Minimal yacs-compatible config tree.

The reference drives everything through a yacs ``CfgNode`` merged from a YAML
preset plus trailing ``KEY VALUE`` CLI pairs (reference: config/defaults.py,
train.py:401-402).  yacs is not a dependency, so this is a small
dependency-free re-implementation of the subset the framework needs:
attribute access, ``merge_from_file``, ``merge_from_list``, ``clone`` and
``dump``.
"""

from __future__ import annotations

import copy
from typing import Any

import yaml


class CfgNode(dict):
    """A dict with attribute access and yacs-style merge semantics."""

    def __init__(self, init_dict: dict | None = None):
        super().__init__()
        if init_dict:
            for k, v in init_dict.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    # -- merging -------------------------------------------------------------
    def merge_from_other(self, other: "CfgNode") -> None:
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self.get(k), CfgNode):
                self[k].merge_from_other(CfgNode(v) if not isinstance(v, CfgNode) else v)
            else:
                self[k] = _coerce(v, self.get(k))

    def merge_from_file(self, filename: str) -> None:
        with open(filename) as f:
            loaded = yaml.safe_load(f) or {}
        self.merge_from_other(CfgNode(loaded))

    def merge_from_list(self, opts: list) -> None:
        if len(opts) % 2:
            raise ValueError(f"Override list must be key/value pairs, got {opts}")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            old = node.get(parts[-1])
            if isinstance(value, str):
                value = yaml.safe_load(value)
            node[parts[-1]] = _coerce(value, old)

    # -- utilities -----------------------------------------------------------
    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def to_dict(self) -> dict:
        return {k: (v.to_dict() if isinstance(v, CfgNode) else v)
                for k, v in self.items()}

    def dump(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    def __deepcopy__(self, memo):
        out = CfgNode()
        for k, v in self.items():
            out[k] = copy.deepcopy(v, memo)
        return out


def _coerce(value: Any, old: Any) -> Any:
    """Coerce ``value`` toward the type of ``old`` (yacs-style type checking)."""
    if old is None or value is None:
        return value
    if isinstance(old, bool) and not isinstance(value, bool):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(old, tuple) and isinstance(value, (list, tuple)):
        return tuple(value)
    if isinstance(old, tuple) and isinstance(value, str):
        # yacs-style "(300, 375, 450)" tuple literals in YAML presets
        stripped = value.strip()
        if stripped.startswith("(") and stripped.endswith(")"):
            return tuple(yaml.safe_load("[" + stripped[1:-1] + "]"))
    if isinstance(old, float) and isinstance(value, int):
        return float(value)
    return value
