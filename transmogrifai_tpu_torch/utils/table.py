"""ASCII table pretty-printer.

The port's copy of ``transmogrifai_tpu/utils/table.py`` (reference Table,
utils/src/main/scala/com/salesforce/op/utils/table/Table.scala), used by
the listener's stage profile.
"""
from __future__ import annotations

from typing import Any, List, Sequence

__all__ = ["Table"]


class Table:
    def __init__(self, columns: Sequence[str],
                 rows: Sequence[Sequence[Any]], name: str = ""):
        if not columns:
            raise ValueError("Table requires at least one column")
        for r in rows:
            if len(r) != len(columns):
                raise ValueError(
                    f"Row {r!r} has {len(r)} cells; expected {len(columns)}")
        self.columns = [str(c) for c in columns]
        self.rows = [[_fmt(c) for c in r] for r in rows]
        self.name = name

    def pretty(self) -> str:
        widths = [max(len(self.columns[j]),
                      *(len(r[j]) for r in self.rows)) if self.rows
                  else len(self.columns[j])
                  for j in range(len(self.columns))]
        sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"

        def line(cells: Sequence[str]) -> str:
            return "|" + "|".join(
                f" {c:<{w}} " for c, w in zip(cells, widths)) + "|"

        out: List[str] = []
        if self.name:
            total = len(sep)
            out.append("=" * total)
            out.append(f"|{self.name:^{total - 2}}|")
        out.append(sep)
        out.append(line(self.columns))
        out.append(sep)
        for r in self.rows:
            out.append(line(r))
        out.append(sep)
        return "\n".join(out)

    def __str__(self) -> str:
        return self.pretty()


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.4f}"
    return str(v)
