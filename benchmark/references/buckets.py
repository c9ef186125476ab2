"""The reference of a served MatrixBuckets scene: what the serve harness
sends, and what the program's frames of it must hold, bit for bit.

The serve runner (``psbench/serve.py``) knows no data layout: it asks the
reference that the configuration's ``reference`` key names (this one when
the key is absent; ``psbench/cells.py:reference``) for each of these:

- ``draw(cfg, seed, k, drop)``: the ``k``-th scene of a run, (particles,
  metadata) as sent, the last ``drop`` particles left out;
- ``loaded(particles, metadata, device)``: the layout the program holds
  once it has loaded that scene;
- ``frame(layout, metadata, steps, device, low=False)``: the layout one
  frame of ``steps`` steps later, under ``metadata``'s parameters; with
  ``low`` the control (``control.py``): the same frame one precision lower;
- ``pack(layout)``: the particles in the order the program ships them;
- ``from_snapshot(snap, particles, metadata, device)``: the layout of a state
  the daemon copied (``daemon_child.py``: the live slots' fields, their
  ``index`` in the flat state and the ``data_structure``; for a bucket grid
  also ``grid``, ``bucket`` and ``slot``), or None when the copy does not
  belong to the scene (particles, metadata) it was taken from;
- ``least(layout)``: ``{"bound_ms": ...}``, the least time of one step at
  the card's published peaks (``psbench/roofline.py``), or None.

Here the scene is the editor's hex lattice (``scenes.hex_lattice``), laid
out on the grid the engine picks for it (``scenes.scene_grid``,
``scenes.bucketize``), stepped by ``refsim``, and shipped in (bucket, slot)
order; a step's least time counts the live pairs of each receiver's 3x3
bucket window.
"""

from __future__ import annotations

from psbench import refsim, roofline, scenes, wire


def draw(cfg: dict, seed: int, k: int, drop: int):
    return scenes.hex_lattice(cfg, [seed, k], drop=drop)


def loaded(parts, meta, device) -> refsim.Layout:
    g = scenes.scene_grid(parts, meta)
    kept, bucket, slot = scenes.bucketize(parts, g)
    return refsim.from_particles(kept, bucket, slot, g, device)


def frame(lay: refsim.Layout, meta, steps: int, device, low: bool = False) -> refsim.Layout:
    return refsim.frame(lay, refsim.params_vector(meta, device), steps, low)


pack = refsim.pack


def from_snapshot(snap: dict, parts, meta, device) -> refsim.Layout | None:
    g = scenes.scene_grid(parts, meta)
    if "grid" not in snap or tuple(int(v) for v in snap["grid"]) != tuple(g)[:3]:
        return None
    return refsim.from_particles(wire.from_fields(snap), snap["bucket"], snap["slot"], g,
                                 device)


def least(lay: refsim.Layout) -> dict:
    g = lay.grid
    counts = roofline.counts_of(lay.bucket, g.by, g.bx)
    return roofline.step_least_ms(roofline.pairs_from_counts(counts), len(lay.x))
