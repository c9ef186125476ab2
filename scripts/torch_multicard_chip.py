#!/usr/bin/env python3
"""The phases of ``chip_smoke.py`` that exist only across cards, alone.

On a machine with several cards, from the repository root:

    python3 scripts/torch_multicard_chip.py

builds the kernels, prints every card's ``nvidia-smi`` name and power limit,
then runs ``chip_smoke.multi_card``: the dense scene's sharded frame and the
1024x1024 editor lattice's serve on the single-controller mesh of every card
(phases 10 and 11), the bench's ``--sharded`` mode over every card, its halo
kernels held against their plain versions (phase 22's run), then phase 20
with one process a card over NCCL (the
sharded frame bit for bit against one card, the serve through
``scripts/torch_launch_multihost.sh``), then phase 23 at 16M particles: the
dense row on the first card, the sharded row over every card and phase 20's
NCCL frame at the 16M grid (``chip_smoke.multi_card_scale``). Each phase
prints its JSON line; any failure raises. It exits non-zero with fewer than
two cards.
"""

from __future__ import annotations

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    if torch.cuda.device_count() < 2:
        print(f"torch_multicard_chip: {torch.cuda.device_count()} CUDA devices; "
              "this script needs two or more", file=sys.stderr)
        return 2
    import chip_smoke
    from particle_simulator_tpu_torch.ops import build
    from particle_simulator_tpu_torch.physics.bucket import GridConfig

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    build.library()
    chip_smoke.multi_card("cuda", GridConfig(8, 9, 8))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
