"""Minimal yacs-style config nodes (port of stitchax/utils/config.py).

The CLIs stack argparse + python-module configs (`inf_configs`,
`configs`) into one `CfgNode`: attribute access, recursive dict merging
and the sorted `dump` that the stitch CLI writes to config.txt, byte for
byte as stitchax writes it. Also yacs' `merge_from_list` (dotted-key
overrides from the command line, coerced to the existing value's type),
`freeze` / `defrost` and `clone`.
"""

from __future__ import annotations

import copy
from typing import Any, Dict


class CfgNode(dict):
    """A dict with attribute access, recursive merge and freezing."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict: Dict[str, Any] | None = None):
        super().__init__()
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        if init_dict:
            for k, v in init_dict.items():
                self[k] = self._to_node(v)

    @classmethod
    def _to_node(cls, v):
        if isinstance(v, dict) and not isinstance(v, CfgNode):
            return cls(v)
        return v

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def __setitem__(self, key, value):
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(f"CfgNode is frozen; cannot set {key}")
        super().__setitem__(key, self._to_node(value))

    def merge_from_dict(self, other: Dict[str, Any]):
        for k, v in other.items():
            if k in self and isinstance(self[k], CfgNode) and isinstance(v, dict):
                self[k].merge_from_dict(v)
            else:
                self[k] = self._to_node(copy.deepcopy(v))
        return self

    def merge_from_list(self, opts):
        """Apply ["a.b", "value", ...] overrides, each value coerced to the
        type of the value it replaces (`_coerce`)."""
        if len(opts) % 2:
            raise ValueError("override list must be key value pairs")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            node[parts[-1]] = _coerce(value, node.get(parts[-1]))
        return self

    def freeze(self):
        """Refuse every later assignment, in nested nodes too."""
        return self._set_immutable(True)

    def defrost(self):
        return self._set_immutable(False)

    def _set_immutable(self, flag: bool):
        object.__setattr__(self, CfgNode.IMMUTABLE, flag)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(flag)
        return self

    def clone(self) -> "CfgNode":
        """A deep, unfrozen copy."""
        return CfgNode(copy.deepcopy(self.to_dict()))

    def to_dict(self) -> Dict[str, Any]:
        return {k: v.to_dict() if isinstance(v, CfgNode) else v
                for k, v in self.items()}

    def dump(self, indent: int = 0) -> str:
        """Sorted `key: repr(value)` lines, nested nodes indented."""
        lines = []
        for k in sorted(self.keys()):
            v = self[k]
            pad = "  " * indent
            if isinstance(v, CfgNode):
                lines.append(f"{pad}{k}:")
                lines.append(v.dump(indent + 1))
            else:
                lines.append(f"{pad}{k}: {v!r}")
        return "\n".join(lines)

    def __repr__(self):
        return f"CfgNode({dict.__repr__(self)})"

    def __deepcopy__(self, memo):
        return CfgNode(copy.deepcopy(self.to_dict(), memo))


def _coerce(value: Any, old: Any):
    """A command-line string override as the type of the value it replaces
    (bools from 1 / true / yes / on); over None an int, a float or a bool
    where the string reads as one; else the string."""
    if not isinstance(value, str):
        return value
    if isinstance(old, bool):
        return value.lower() in ("1", "true", "yes", "on")
    for cast in (int, float):
        if isinstance(old, cast):
            try:
                return cast(value)
            except ValueError:
                pass
    if old is None:
        for cast in (int, float):
            try:
                return cast(value)
            except ValueError:
                continue
        if value.lower() in ("true", "false"):
            return value.lower() == "true"
    return value
