"""The control of the comparison that decides ``correct``, at a cell's size.

    python benchmark/control.py --workload NAME --seeds 1,2,3 [--device cuda]

For each seed it draws the cell's scene, computes its first frame with the
reference in f32 (what the comparison holds the program to) and with the
reference in bfloat16 in the program's place (the control: the pair terms,
their sum and the kick one precision lower), and prints, as one JSON line a
seed, how many particles the comparison finds different. A served cell's
scene, frames and comparison are its configuration's reference's
(``benchmark/references/``), as in its runs. The limit of every
number compared is 0, so a control that reads above 0 on every seed fails
as it must. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from psbench import cells, frames, refsim, scenes  # noqa: E402


def control_reading(workload: str, seed: int, device: str, root: str = cells.ROOT) -> dict:
    wl, cfg, traffic = cells.cell(cells.load(root), workload, root)
    steps = int(cfg["steps_per_frame"])
    t = time.perf_counter()
    if traffic["mode"] == "serve":
        ref = cells.reference(cfg, root)
        parts, meta = ref.draw(cfg, seed, 0, 0)
        lay = ref.loaded(parts, meta, device)
        sound = ref.pack(ref.frame(lay, meta, steps, device))
        control = ref.pack(ref.frame(lay, meta, steps, device, low=True))
        compared, mismatch = len(sound), refsim.mismatches(control, sound)
    else:
        g = frames.grid_of(cfg)
        scene, meta, live = scenes.dense_crystal(g, seed, cfg["step_dt"], device, cfg["fill"])
        boxes = frames.region(g, live, seed, traffic, steps)
        inner, outer = (None, None) if boxes is None else boxes
        lay = frames.crop(refsim.from_grid(scene, g), outer)
        params = refsim.params_vector(meta, device)
        sound = frames.crop(refsim.frame(lay, params, steps), inner)
        control = frames.crop(refsim.frame(lay, params, steps, low=True), inner)
        compared, mismatch = len(sound.x), refsim.layout_mismatches(control, sound)
    return {"workload": workload, "seed": seed, "compared": compared,
            "control_mismatch": mismatch, "limit": 0, "seconds": time.perf_counter() - t}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(control_reading(args.workload, seed, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
