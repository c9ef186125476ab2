"""Wrapper of the all-pairs CUDA kernel (the CompactArray step).

Counterpart of ``particle_simulator_tpu/ops/allpairs_pallas.py``:

- ``allpairs_step_cuda``       -> ``csrc/allpairs_step.cu`` (``_allpairs_kernel``)
- ``run_frame_allpairs_cuda``  = ``steps`` of them, a frame.

The wrapper checks dtype, shape, contiguity and device. A flat ``(N,)``
state on the CPU goes to the plain PyTorch version
(``physics/step.py:allpairs_step``); on a CUDA device it launches the kernel
on ``torch.cuda.current_stream()``; any other device raises. Outputs are
allocated fresh on every call, so a state a readback still holds is never
overwritten. ``LAUNCHES["allpairs"]`` counts kernel launches, and only those.
"""

from __future__ import annotations

import torch

from particle_simulator_tpu_torch.engine.state import NPARAMS, ParticleState
from particle_simulator_tpu_torch.ops.bucket_cuda import check_aux, check_fields, launch
from particle_simulator_tpu_torch.physics import step

LAUNCHES = {"allpairs": 0}


def allpairs_step_cuda(state: ParticleState, params: torch.Tensor) -> ParticleState:
    """One all-pairs physics step (cursor, wall, Mie pairs over every live
    slot, leapfrog) of a flat ``(N,)`` state; ``params`` is the (10,) f32
    vector of ``SimParams.vector`` on the state's device."""
    shape, device = state.x.shape, state.x.device
    if len(shape) != 1:
        raise ValueError(f"expected a flat (N,) state, got shape {tuple(shape)}")
    if state.capacity >= 2**31:
        raise ValueError(f"{state.capacity} slots exceed the int32 slot ids")
    on_cuda = check_fields(state)
    check_aux(params, "params", torch.float32, (NPARAMS,), device)
    if not on_cuda:
        return step.allpairs_step(state, params)
    n = shape[0]
    with torch.cuda.device(device):
        out = [torch.empty_like(a) for a in state[:4]]
        if n:
            launch("ps_allpairs_step", *(a.data_ptr() for a in state), params.data_ptr(),
                   *(o.data_ptr() for o in out), n)
            LAUNCHES["allpairs"] += 1
    return ParticleState(*out, state.ty)


def run_frame_allpairs_cuda(state: ParticleState, params: torch.Tensor,
                            steps: int) -> ParticleState:
    """One frame of ``steps`` kernel steps; ``steps`` is a plain int."""
    return step.run_frame(state, params, steps, allpairs_step_cuda)
