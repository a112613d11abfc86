"""Assigned input shapes (same four for every LM architecture); a copy
of ``repro.configs.shapes``.

  train_4k     seq 4,096   global_batch 256   -> train_step
  prefill_32k  seq 32,768  global_batch 32    -> serve_prefill
  decode_32k   seq 32,768  global_batch 128   -> serve_decode (1 new token,
                                                KV cache of seq_len)
  long_500k    seq 524,288 global_batch 1     -> serve_decode; requires
                                                sub-quadratic attention
                                                (SSM / hybrid / windowed)

Skips:
  * long_500k is skipped for pure full-attention archs,
  * no arch here is encoder-only, so decode shapes apply to all.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg, shape: ShapeSpec) -> tuple:
    """(applicable, reason)."""
    if shape.name == "long_500k":
        sub_quadratic = (
            cfg.family in ("ssm", "hybrid")
            or (cfg.window_size > 0)
        )
        if not sub_quadratic:
            return False, "pure full-attention arch — long_500k skipped"
    return True, ""
