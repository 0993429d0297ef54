"""Minimal yacs-style config nodes (the part of stitchax/utils/config.py
the CLIs use).

The CLIs stack argparse + python-module configs (`inf_configs`,
`configs`) into one `CfgNode`: attribute access, recursive dict merging
and the sorted `dump` that the stitch CLI writes to config.txt, byte for
byte as stitchax writes it.
"""

from __future__ import annotations

import copy
from typing import Any, Dict


class CfgNode(dict):
    """A dict with attribute access and recursive merge."""

    def __init__(self, init_dict: Dict[str, Any] | None = None):
        super().__init__()
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
        super().__setitem__(key, self._to_node(value))

    def merge_from_dict(self, other: Dict[str, Any]):
        for k, v in other.items():
            if k in self and isinstance(self[k], CfgNode) and isinstance(v, dict):
                self[k].merge_from_dict(v)
            else:
                self[k] = self._to_node(copy.deepcopy(v))
        return self

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
