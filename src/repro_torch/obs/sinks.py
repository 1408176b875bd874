"""Metric sinks: in memory (tests), a JSONL file (runs), a periodic console
line (the port's copy of ``repro/obs/sinks.py``).

Every sink receives every registry row (events at once, instruments at
``tick``; see :mod:`repro_torch.obs.registry`).  Rows are plain dicts with
``kind`` / ``name`` / ``seq`` / ``t`` and the fields of their kind; ``t``
is the only wall-clock field, so :func:`strip_walltimes` makes two runs'
streams comparable.
"""
from __future__ import annotations

import json
from typing import Iterable, Optional


class MemorySink:
    """Keep rows in a list (tests)."""

    def __init__(self):
        self.rows: list = []

    def write(self, row: dict) -> None:
        self.rows.append(dict(row))

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass

    def events(self, name: Optional[str] = None) -> list:
        return [r for r in self.rows if r["kind"] == "event"
                and (name is None or r["name"] == name)]


class JsonlSink:
    """One JSON row per line, keys sorted (streams that diff)."""

    def __init__(self, path):
        self.path = path
        self._f = open(path, "w")

    def write(self, row: dict) -> None:
        self._f.write(json.dumps(row, sort_keys=True, default=str) + "\n")

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()


def strip_walltimes(lines: Iterable[str]) -> list:
    """Drop the wall-clock field ``t`` from JSONL rows: two runs of the same
    recording sequence are then equal line for line."""
    out = []
    for ln in lines:
        if not ln.strip():
            continue
        row = json.loads(ln)
        row.pop("t", None)
        out.append(json.dumps(row, sort_keys=True))
    return out


class ConsoleSink:
    """One summary line of the latest instrument and event values, at each
    ``tick`` row whose step is a multiple of ``every`` (and at ``close``).
    ``prefixes`` filters the names shown (None: all)."""

    def __init__(self, every: int = 20, log=print, prefixes=None):
        if every < 1:
            raise ValueError("ConsoleSink every must be >= 1")
        self.every = every
        self.log = log
        self.prefixes = tuple(prefixes) if prefixes else None
        self._latest: dict = {}
        self._dirty = False
        self._last_printed_step: Optional[int] = None

    def _want(self, name: str) -> bool:
        return self.prefixes is None or name.startswith(self.prefixes)

    @staticmethod
    def _fmt(v) -> str:
        if isinstance(v, float):
            return f"{v:.4g}"
        if isinstance(v, dict):
            return "{" + ",".join(
                f"{k}={ConsoleSink._fmt(x)}" for k, x in sorted(v.items())
                if isinstance(x, (int, float))) + "}"
        return str(v)

    def write(self, row: dict) -> None:
        kind = row["kind"]
        if kind == "tick":
            step = row.get("step")
            if (step is not None and step % self.every == 0
                    and step != self._last_printed_step):
                self._print(step)
            return
        if not self._want(row["name"]):
            return
        if kind in ("event", "counter", "gauge"):
            self._latest[row["name"]] = row["value"]
        else:  # histogram
            self._latest[row["name"]] = {
                k: row[k] for k in ("count", "p50", "p99") if k in row}
        self._dirty = True

    def _print(self, step) -> None:
        if not self._dirty:
            return
        parts = [f"{k}={self._fmt(v)}" for k, v in sorted(self._latest.items())]
        self.log(f"  [obs step {step}] " + "  ".join(parts))
        self._dirty = False
        self._last_printed_step = step

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self._print("end")
