#!/usr/bin/env python3
"""Time the port's single-device bucket kernels of two checkouts on one card,
in turns (A, B, B, A), each turn in its own process with its own kernel build.

Run on a machine with one NVIDIA H100, from the root of checkout B, with
checkout A unpacked somewhere git ignores, e.g. the parent commit:

    git archive HEAD~1 | tar -x -C particle_simulator_tpu_torch/build/parent
    python3 scripts/torch_kernel_ab.py particle_simulator_tpu_torch/build/parent

Each turn runs ``chip_smoke.phase_kernels`` of its checkout (the dense
512x256x8 scene, 50 launches a kernel after a warm-up, CUDA events) and
prints one JSON line of kernel and library-call times in ms. Exits non-zero
when a turn fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

TURN = r'''
import json
import chip_smoke as cs
from particle_simulator_tpu_torch.ops import build
from particle_simulator_tpu_torch.physics.bucket import GridConfig
lib = build.library()
sass = cs.sass_pair_counts(build.BUILD_DIR / build.LIB_NAME, "allpairs_step_kernel",
                           lib.ps_allpairs_pairs_per_iter())
r = cs.phase_kernels("cuda", GridConfig(8, 9, 8), GridConfig(4, 4, 16), reps=50, sass=sass)
print("RESULT " + json.dumps(r["dense"]["ms"]))
'''


def main(argv: list[str]) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    here = os.getcwd()
    other = os.path.abspath(argv[0])
    for label, root in (("A", other), ("B", here), ("B", here), ("A", other)):
        proc = subprocess.run([sys.executable, "-c", TURN], cwd=root, capture_output=True,
                              text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode or not lines:
            print(f"turn {label} ({root}) failed:\n{proc.stderr[-3000:]}", file=sys.stderr)
            return 1
        ms = json.loads(lines[0][len("RESULT "):])
        print(json.dumps({"checkout": label, "root": root,
                          "ms": {k: v for k, v in ms.items() if "plain" not in k}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
