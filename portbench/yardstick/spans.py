"""Per-step numbers from a snapshot of the program's tracer
(`stitchax_torch.utils.tracing.snapshot()`, kept by a traced run in
`layer["program"]`): spans carry their root's id, so each closed root span
gathers the spans of one step."""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Mapping, Optional


def roots(program: Optional[Mapping], root_name: str) -> List[int]:
    """The root ids of the closed outermost spans named `root_name`."""
    return [s["root"] for s in (program or {}).get("spans", [])
            if s["name"] == root_name and s["parent"] is None]


def per_root(program: Optional[Mapping], root_name: str,
             names: Iterable[str], field: str) -> List[float]:
    """For each closed root span `root_name`, the sum of `field`
    ("device_ms" or "host_ms") over its spans named in `names`; roots that
    hold none of them are left out."""
    names = set(names)
    sums: Dict[int, float] = {}
    for s in (program or {}).get("spans", []):
        if s["name"] in names and s[field] is not None:
            sums[s["root"]] = sums.get(s["root"], 0.0) + s[field]
    return [sums[r] for r in roots(program, root_name) if r in sums]


def median(values: List[float]) -> Optional[float]:
    return statistics.median(values) if values else None
