"""The least time of a step, frozen: per-pair counts and the H100's peaks.

Copied from ``chip_smoke.py`` (``FORCE_LAW_COUNTS``, ``ops_bound_ms``,
``bound``, ``bucket_pairs``) so a later change cannot move the yardstick.
Pairs are counted from the data: every live receiver times the live
particles of its 3x3 bucket window, itself left out, whatever slots a
kernel visits. Bytes are each live slot's 20 read and 16 written once.
"""

from __future__ import annotations

import torch

# NVIDIA's data sheet for the H100 SXM at 700 W: 3.35 TB/s of HBM and
# 67 TFLOP/s of f32 outside the tensor cores (an FFMA counts two FLOPs, so
# 33.5e12 f32-pipe instructions a second; the multi-function unit issues an
# eighth of that).
HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 67e12 / 2
MUFU_INSTR_PER_S = FP32_INSTR_PER_S / 8
# instructions of the force law a pair on the two pipes, counted once in the
# SASS of the all-pairs kernel's loop (sm_90a) and frozen
FORCE_LAW_COUNTS = {"fp32_per_pair": 51.0, "mufu_per_pair": 2.0}
STEP_BYTES_PER_LIVE = 20 + 16


def ops_bound_ms(pairs: int, counts: dict = FORCE_LAW_COUNTS) -> float:
    return 1e3 * pairs * max(counts["fp32_per_pair"] / FP32_INSTR_PER_S,
                             counts["mufu_per_pair"] / MUFU_INSTR_PER_S)


def bound(nbytes: int, ops_ms: float = 0.0) -> dict:
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def pairs_from_counts(live: torch.Tensor) -> int:
    """Pair evaluations of a step from the (BY, BX) live counts a bucket."""
    live = live.to(torch.int64)
    by, bx = live.shape
    padded = torch.zeros((by + 2, bx + 2), dtype=torch.int64, device=live.device)
    padded[1:-1, 1:-1] = live
    nbr = sum(padded[dy:dy + by, dx:dx + bx] for dy in range(3) for dx in range(3))
    return int((live * (nbr - 1)).clamp(min=0).sum())


def counts_of(bucket: torch.Tensor, by: int, bx: int) -> torch.Tensor:
    """(BY, BX) live counts from the bucket ids of live particles."""
    return torch.bincount(bucket, minlength=by * bx).reshape(by, bx)


def step_least_ms(pairs: int, live: int) -> dict:
    """The least time of one step: the larger of the pairs' operations at
    the f32 and MUFU peaks and the live slots' bytes at the HBM peak."""
    return bound(live * STEP_BYTES_PER_LIVE, ops_bound_ms(pairs))
