"""The benchmark's own code: the yardstick that later changes to the port
cannot move.

- ``wire``: the frozen wire format (decode and encode);
- ``scenes``: the scene generators, the grid pick and the bucketize;
- ``refsim``: the plain reference of the MatrixBuckets frame, which
  ``benchmark/references/buckets.py`` serves to the ``serve`` runner (each
  data layout a served configuration can name has a module there);
- ``roofline``: the frozen per-pair counts and the H100's published peaks;
- ``stats``: the arithmetic of the end-to-end and per-layer metrics;
- ``trace``: the device trace and its reduction;
- ``serve`` and ``frames``: the two runners a traffic mix's ``mode`` names;
- ``cells``: ``BENCHMARK.json``, configurations, mixes, metric readers and
  references;
- ``nojax``: the check that nothing of JAX or the JAX package was loaded;
- ``faults``: faults planted in the port by the tests that see ``correct``
  fail.

Nothing here imports the port at module level: ``serve`` and ``frames``
import it inside the functions that run it.
"""
