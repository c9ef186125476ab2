"""Simulation state of tensors and the in-band parameters.

Counterpart of ``particle_simulator_tpu/engine/state.py``: SoA fields,
static capacity with ``ty < 0`` tombstones, u32 fixed-point positions. The
one layout difference: ``x``/``y`` are ``torch.int32`` tensors that hold the
u32 bit patterns (torch's CPU ``uint32`` has no ``+``, ``>>`` or ``<``).
int32 add/sub wrap like u32; unsigned compares and shifts are rewritten on
the bit pattern (``physics/mie.py``); the CUDA kernels read the bits as
``uint32_t``. Conversions at the numpy boundary are ``.view``s.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from particle_simulator_tpu_torch.io.frame import PARTICLE_DTYPE, default_metadata

U32_MAX_F = np.float32(4294967295.0)
HALF_U32 = 2147483647  # UINT32_MAX / 2 with C integer division

# The reference hardcodes Argon's mass for every particle; it is not part of
# the frame metadata.
PARTICLE_MASS = np.float32(6.63352599e-26)

# Layout of the f32 params vector every step function and kernel reads
# (the same order as the JAX package's Pallas params vector).
SIGMA, EPS, N, M, CURX, CURY, CURSZ, DT, BW, BH = range(10)
NPARAMS = 10


class ParticleState(NamedTuple):
    """SoA particle state. All tensors share one shape and one device: flat
    ``(capacity,)`` or the bucket grid ``(BY, BX, CAP)``."""

    x: torch.Tensor  # int32 holding the u32 fixed point in [0, box_width)
    y: torch.Tensor  # int32 holding the u32 fixed point in [0, box_height)
    vx: torch.Tensor  # f32 m/s
    vy: torch.Tensor  # f32 m/s
    ty: torch.Tensor  # i32 species; < 0 means null/tombstone

    @property
    def capacity(self) -> int:
        return self.x.numel()

    def reshape(self, shape) -> "ParticleState":
        return ParticleState(*(a.reshape(shape) for a in self))

    def to(self, device) -> "ParticleState":
        return ParticleState(*(a.to(device) for a in self))


def empty_state(shape, device="cpu") -> ParticleState:
    """All-tombstone state of the given shape."""
    return ParticleState(
        x=torch.zeros(shape, dtype=torch.int32, device=device),
        y=torch.zeros(shape, dtype=torch.int32, device=device),
        vx=torch.zeros(shape, dtype=torch.float32, device=device),
        vy=torch.zeros(shape, dtype=torch.float32, device=device),
        ty=torch.full(shape, -1, dtype=torch.int32, device=device),
    )


def _field_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy()).to(device)


def state_from_numpy(parts: np.ndarray, capacity: int, device="cpu") -> ParticleState:
    """Pad a ``PARTICLE_DTYPE`` array to ``capacity`` with tombstones."""
    n = len(parts)
    if n > capacity:
        raise ValueError(f"{n} particles exceed capacity {capacity}")
    full = np.zeros(capacity, dtype=PARTICLE_DTYPE)
    full["ty"] = -1
    full[:n] = parts
    return ParticleState(*(_field_tensor(full[f], device) for f in PARTICLE_DTYPE.names))


def state_to_numpy(state: ParticleState) -> np.ndarray:
    """Full (padded) state as a ``PARTICLE_DTYPE`` array, tombstones included."""
    fields = _fields_numpy(state)
    parts = np.empty(fields[0].size, dtype=PARTICLE_DTYPE)
    for name, a in zip(PARTICLE_DTYPE.names, fields):
        parts[name] = a.reshape(-1)
    return parts


class SimParams(NamedTuple):
    """The frame metadata the physics reads, as f32 scalars (``steps_per_frame``
    an int). Only species 0 drives the physics, as in the reference; species
    1 rides along for wire round trips. ``vector`` packs the ten scalars the
    step reads into the f32 tensor the kernels take, so a metadata edit
    changes a tensor's values and never a kernel's signature."""

    sigma: np.float32
    epsilon: np.float32
    n: np.float32
    m: np.float32
    sigma1: np.float32
    epsilon1: np.float32
    n1: np.float32
    m1: np.float32
    cursor_x: np.float32
    cursor_y: np.float32
    cursor_size: np.float32
    step_dt: np.float32
    steps_per_frame: int
    box_width: np.float32
    box_height: np.float32

    @staticmethod
    def from_record(meta: np.ndarray) -> "SimParams":
        """Build from a ``METADATA_DTYPE`` record (0-d numpy structured)."""
        p0, p1 = meta["particles"][0], meta["particles"][1]
        f32 = np.float32
        return SimParams(
            sigma=f32(p0["sigma"]),
            epsilon=f32(p0["epsilon"]),
            n=f32(p0["n"]),
            m=f32(p0["m"]),
            sigma1=f32(p1["sigma"]),
            epsilon1=f32(p1["epsilon"]),
            n1=f32(p1["n"]),
            m1=f32(p1["m"]),
            cursor_x=f32(meta["cursor_pos"][0]),
            cursor_y=f32(meta["cursor_pos"][1]),
            cursor_size=f32(meta["cursor_size"]),
            step_dt=f32(meta["step_dt"]),
            steps_per_frame=int(meta["steps_per_frame"]),
            box_width=f32(meta["box_width"]),
            box_height=f32(meta["box_height"]),
        )

    def vector(self, device="cpu") -> torch.Tensor:
        """The (10,) f32 params tensor (layout: ``SIGMA`` ... ``BH``). On
        CUDA the upload is asynchronous, from pinned memory."""
        vals = torch.tensor(
            [self.sigma, self.epsilon, self.n, self.m, self.cursor_x,
             self.cursor_y, self.cursor_size, self.step_dt, self.box_width,
             self.box_height],
            dtype=torch.float32,
        )
        device = torch.device(device)
        if device.type == "cuda":
            return vals.pin_memory().to(device, non_blocking=True)
        return vals.to(device)

    def record(self) -> np.ndarray:
        """A ``METADATA_DTYPE`` record carrying these values; the fields
        SimParams does not hold (data structure, device, launch width) keep
        ``default_metadata``'s values."""
        meta = default_metadata()
        meta["particles"][0] = (self.sigma, self.epsilon, self.n, self.m)
        meta["particles"][1] = (self.sigma1, self.epsilon1, self.n1, self.m1)
        meta["cursor_pos"] = (self.cursor_x, self.cursor_y)
        meta["cursor_size"] = self.cursor_size
        meta["step_dt"] = self.step_dt
        meta["steps_per_frame"] = self.steps_per_frame
        meta["box_width"] = self.box_width
        meta["box_height"] = self.box_height
        return meta


def from_reference(fields, meta_record: np.ndarray, device="cpu"):
    """The five numpy arrays of a JAX ``ParticleState`` (x, y as uint32) and
    a ``METADATA_DTYPE`` record -> ``(ParticleState, SimParams)`` on
    ``device``. Shapes are kept."""
    x, y, vx, vy, ty = (np.asarray(a) for a in fields)
    if x.dtype != np.uint32 or y.dtype != np.uint32:
        raise TypeError(f"positions must be uint32, got {x.dtype}/{y.dtype}")
    state = ParticleState(
        _field_tensor(x, device), _field_tensor(y, device),
        _field_tensor(vx.astype(np.float32), device),
        _field_tensor(vy.astype(np.float32), device),
        _field_tensor(ty.astype(np.int32), device),
    )
    return state, SimParams.from_record(meta_record)


def _fields_numpy(state: ParticleState):
    x, y, vx, vy, ty = (a.detach().cpu().numpy() for a in state)
    return x.view(np.uint32), y.view(np.uint32), vx, vy, ty


def to_reference(state: ParticleState, params: SimParams):
    """Inverse of ``from_reference``: ``(fields, meta_record)`` with the five
    numpy arrays in the state's shape (x, y as uint32)."""
    return _fields_numpy(state), params.record()
