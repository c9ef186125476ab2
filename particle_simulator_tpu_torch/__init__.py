"""particle_simulator_tpu_torch — the PyTorch + CUDA port of the engine.

Both force paths of ``particle_simulator_tpu`` (the JAX package, which stays
the reference) rebuilt on PyTorch tensors with CUDA C++ kernels written by
hand for Hopper (``ops/csrc/*.cu``, built with ``nvcc`` for ``sm_90a`` at
first use): MatrixBuckets (step, rebucket dest, rebucket place) and
CompactArray (the all-pairs step).

  engine/   <- engine/state.py, simulator.py, daemon.py : state, frames, TCP loop
  physics/  <- physics/mie.py, step.py, bucket.py        : plain torch versions
  ops/      <- ops/bucket_pallas.py, allpairs_pallas.py,
               readback.py                               : kernel wrappers, readback
  io/       <- io/frame.py, transport.py, presets.py,
               native.py                                 : the wire codec (a copy)
  parallel/ <- parallel/domain.py, multihost.py          : the sharded grid, in one
                                                           process or several
  scenes/   <- scenes/library.py, order.py               : scene builders, order
  editor/   <- editor/*.py                               : the editor (headless, web),
                                                           numpy only (a copy)
  utils/    <- utils/profiling.py, log.py, numfmt.py ... : span recorder, logging, numbers

Positions are ``torch.int32`` tensors holding the u32 fixed-point bit
patterns: torch's CPU ``uint32`` has no add, shift or compare, while int32
add/sub wrap exactly like u32 and the kernels reinterpret the bits. Nothing
here imports jax or the JAX package: the frozen wire codec is the port's own
copy in ``io/``, the editor its own copy in ``editor/``.
"""

__version__ = "0.2.0"
