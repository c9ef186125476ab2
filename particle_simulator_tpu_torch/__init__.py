"""particle_simulator_tpu_torch — the PyTorch + CUDA port of the engine.

The MatrixBuckets serving path of ``particle_simulator_tpu`` (the JAX
package, which stays the reference) rebuilt on PyTorch tensors with three
CUDA C++ kernels written by hand for Hopper (``ops/csrc/*.cu``, built with
``nvcc`` for ``sm_90a`` at first use):

  engine/   <- engine/state.py, simulator.py, daemon.py : state, frames, TCP loop
  physics/  <- physics/mie.py, step.py, bucket.py        : plain torch versions
  ops/      <- ops/bucket_pallas.py, readback.py         : kernel wrappers, readback
  utils/    <- utils/profiling.py                        : StepMeter

Positions are ``torch.int32`` tensors holding the u32 fixed-point bit
patterns: torch's CPU ``uint32`` has no add, shift or compare, while int32
add/sub wrap exactly like u32 and the kernels reinterpret the bits. The wire
codec is the JAX package's jax-free ``particle_simulator_tpu.io``; nothing
here imports jax.
"""

__version__ = "0.1.0"
