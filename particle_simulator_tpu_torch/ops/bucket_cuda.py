"""Wrappers of the three bucket-grid CUDA kernels.

Counterpart of ``particle_simulator_tpu/ops/bucket_pallas.py``:

- ``bucket_step_cuda``  -> ``csrc/bucket_step.cu``  (``_step_kernel``)
- ``move_dest_cuda``    -> ``csrc/bucket_dest.cu``  (``_dest_kernel``)
- ``bucket_place_cuda`` -> ``csrc/bucket_place.cu`` (``_place_kernel``)
- ``bucket_move_cuda`` = dest then place; ``run_frame_bucket_cuda`` = the
  frame schedule over step and move.

Each wrapper checks dtype, shape, contiguity and device. A state on the CPU
goes to the plain PyTorch version in ``physics/bucket.py``; a state on a
CUDA device launches the kernel on ``torch.cuda.current_stream()``; any other
device raises. Outputs are allocated fresh on every call, so a state a
readback still holds is never overwritten. ``LAUNCHES`` counts kernel
launches per kernel, and only those.
"""

from __future__ import annotations

import torch

from particle_simulator_tpu_torch.engine.state import NPARAMS, ParticleState
from particle_simulator_tpu_torch.physics import bucket

LAUNCHES = {"step": 0, "dest": 0, "place": 0}

_DTYPES = (torch.int32, torch.int32, torch.float32, torch.float32, torch.int32)


def check_fields(state: ParticleState) -> bool:
    """Validate the five fields' dtypes, shapes, devices and contiguity;
    True for CUDA, False for the CPU, and raise for any other device."""
    shape, device = state.x.shape, state.x.device
    for name, a, dtype in zip(ParticleState._fields, state, _DTYPES):
        if a.dtype != dtype:
            raise TypeError(f"field {name}: expected {dtype}, got {a.dtype}")
        if a.shape != shape or a.device != device:
            raise ValueError(f"field {name}: shape/device {tuple(a.shape)}/{a.device} "
                             f"differ from x's {tuple(shape)}/{device}")
        if not a.is_contiguous():
            raise ValueError(f"field {name} is not contiguous")
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}: the kernels run on CUDA, "
                         "the plain versions on the CPU")
    return True


def _on_cuda(state: ParticleState) -> bool:
    """Validate a (BY, BX, CAP) state; True for CUDA, False for the CPU."""
    shape = state.x.shape
    if len(shape) != 3:
        raise ValueError(f"expected a (BY, BX, CAP) grid, got shape {tuple(shape)}")
    bucket.grid_log2(state)
    if shape[0] < 2 or shape[1] < 2:
        raise ValueError(f"grid must be at least 2x2 buckets, got {shape[0]}x{shape[1]}")
    if state.capacity >= 2**31:
        raise ValueError(f"{state.capacity} slots exceed the int32 slot ids")
    return check_fields(state)


def check_aux(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def launch(name: str, *args) -> None:
    from particle_simulator_tpu_torch.ops.build import library

    fn = getattr(library(), name)
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def bucket_step_cuda(state: ParticleState, params: torch.Tensor) -> ParticleState:
    """One physics step (cursor, wall, 3x3 Mie pairs, leapfrog); ``params``
    is the (10,) f32 vector of ``SimParams.vector`` on the state's device."""
    on_cuda = _on_cuda(state)
    check_aux(params, "params", torch.float32, (NPARAMS,), state.x.device)
    if not on_cuda:
        return bucket.bucket_step(state, params)
    by, bx, cap = state.x.shape
    with torch.cuda.device(state.x.device):
        out = [torch.empty_like(a) for a in state[:4]]
        launch("ps_bucket_step", *(a.data_ptr() for a in state), params.data_ptr(),
               *(o.data_ptr() for o in out), by, bx, cap)
    LAUNCHES["step"] += 1
    return ParticleState(*out, state.ty)


def move_dest_cuda(state: ParticleState) -> torch.Tensor:
    """(BY, BX, CAP) int32 destination slot per source slot, -1 = dropped."""
    if not _on_cuda(state):
        return bucket.move_dest_direct(state)
    by, bx, cap = state.x.shape
    bx_log2, by_log2 = bucket.grid_log2(state)
    with torch.cuda.device(state.x.device):
        destid = torch.empty_like(state.ty)
        launch("ps_bucket_dest", state.x.data_ptr(), state.y.data_ptr(),
               state.ty.data_ptr(), destid.data_ptr(), by, bx, cap, bx_log2, by_log2)
    LAUNCHES["dest"] += 1
    return destid


def bucket_place_cuda(state: ParticleState, destid: torch.Tensor) -> ParticleState:
    """Move kept particles to their ``destid`` slots, tombstone the rest."""
    on_cuda = _on_cuda(state)
    check_aux(destid, "destid", torch.int32, state.x.shape, state.x.device)
    if not on_cuda:
        return bucket.bucket_place(state, destid)
    with torch.cuda.device(state.x.device):
        out = [torch.empty_like(a) for a in state]
        launch("ps_bucket_place", *(a.data_ptr() for a in state), destid.data_ptr(),
               *(o.data_ptr() for o in out), state.capacity)
    LAUNCHES["place"] += 1
    return ParticleState(*out)


def bucket_move_cuda(state: ParticleState) -> ParticleState:
    """The rebucket pass: dest kernel, then place kernel."""
    return bucket_place_cuda(state, move_dest_cuda(state))


def run_frame_bucket_cuda(state: ParticleState, params: torch.Tensor, steps: int,
                          move_every: int = 16) -> ParticleState:
    """One frame: ``steps`` kernel steps, rebucketing before steps 1, 1+k, ...
    (``physics/bucket.py:chunked_frame_schedule``). ``steps`` is a plain int,
    so a live steps-per-frame edit changes nothing but the loop count."""
    return bucket.chunked_frame_schedule(
        state, steps, move_every, lambda s: bucket_step_cuda(s, params), bucket_move_cuda,
    )
