"""The dry run's input shapes (a copy of ``repro/configs/shapes.py``; the
same 4 shapes for every LM arch).

``decode_*``/``long_*`` trace the serving step (one new token against a
seq_len-deep KV/state cache), NOT the train step.  ``long_500k`` runs only
for sub-quadratic archs (ssm/hybrid) — see DESIGN.md §5 skip table.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# families allowed to run long_500k (sub-quadratic decode state)
LONG_OK_FAMILIES = ("ssm", "hybrid")


def applicable_shapes(family: str) -> list[str]:
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if family in LONG_OK_FAMILIES:
        names.append("long_500k")
    return names
