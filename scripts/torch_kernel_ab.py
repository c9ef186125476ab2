#!/usr/bin/env python3
"""Time the port's single-device kernels of two checkouts on one card, in
turns (A, B, B, A), each turn in its own process with its own kernel build.

Run on a machine with one NVIDIA H100, from the root of checkout B, with
checkout A unpacked somewhere git ignores, e.g. the parent commit:

    git archive HEAD~1 | tar -x -C particle_simulator_tpu_torch/build/parent
    python3 scripts/torch_kernel_ab.py particle_simulator_tpu_torch/build/parent

Each turn runs, through its own checkout's ``chip_smoke`` phases (50 launches
a kernel after a warm-up, CUDA events): ``phase_kernels`` and
``phase_halo_kernels`` (the dense 512x256x8 scene: step, dest, place and
their halo modes), ``phase_allpairs_kernel`` (``gas-diffusion-16k``) plus the
all-pairs step on the 2,048-slot droplet, and ``phase_ext_kernels`` (the 1M
user scene at its loaded state, omax 6: the classic, every-tile ``ext`` and
live-tiles ``compact`` steps) plus the same three steps on the state four
classic frames later (omax 8), the dest on the user scene, and the classic
step and the dest on the editor's 1024x1024 lattice (a 512x512x16 grid).
Every phase also holds each kernel against its plain version. A turn prints
one JSON line of kernel times in ms; the card's ``nvidia-smi`` name and power
limit come first. Exits non-zero when a turn fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

TURN = r'''
import json
import chip_smoke as cs
from particle_simulator_tpu_torch.engine.simulator import Simulator
from particle_simulator_tpu_torch.ops import build
from particle_simulator_tpu_torch.ops import bucket_cuda as bc
from particle_simulator_tpu_torch.ops.allpairs_cuda import allpairs_step_cuda
from particle_simulator_tpu_torch.physics import bucket
from particle_simulator_tpu_torch.physics.bucket import GridConfig
from particle_simulator_tpu_torch.scenes.library import _scene, liquid_droplet
lib = build.library()
# the per-pair counts only feed the phases' bounds, which this script drops
counts = getattr(cs, "FORCE_LAW_COUNTS", None) or cs.sass_pair_counts(
    build.BUILD_DIR / build.LIB_NAME, "allpairs_step_kernel", lib.ps_allpairs_pairs_per_iter())
dense, stress, reps, dev = GridConfig(8, 9, 8), GridConfig(4, 4, 16), 50, "cuda"
ms = {k: v for k, v in cs.phase_kernels(dev, dense, stress, reps=reps, sass=counts)
      ["dense"]["ms"].items() if "plain" not in k}
halo = cs.phase_halo_kernels(dev, dense, stress, reps=reps, sass=counts)["dense"]["ms"]
ms.update({k + "_halo": halo[k] for k in ("step", "dest", "place")})
ms["allpairs_16384"] = cs.phase_allpairs_kernel(dev, reps=reps, sass=counts)[
    "gas_diffusion"]["ms"]["kernel"]
state, pv, _ = cs.compact_state(liquid_droplet(), dev)
ms["allpairs_2048"] = cs.cuda_ms(lambda: allpairs_step_cuda(state, pv), reps)
scene = cs.user_scene()
user = cs.phase_ext_kernels(dev, scene, stress, reps=reps, sass=counts)["user"]
ms.update({f"{k}_omax{user['omax']}": user["ms"][k] for k in ("classic", "ext", "compact")})
sim = Simulator(device=dev)
sim.load_frame(scene)
state, pv = sim.state, sim._pvec
ms["dest_user"] = cs.cuda_ms(lambda: bc.move_dest_cuda(sim.state), reps)
for _ in range(4):
    state = bc.run_frame_bucket_cuda(state, pv, sim.params.steps_per_frame, sim.grid.move_every)
aux = bucket.ext_step_aux(state, pv, sim._lane_chunks, 8)
omax, pair = int(aux.params[-1]), bc.ext_pair(state)
ms[f"classic_omax{omax}"] = cs.cuda_ms(lambda: bc.bucket_step_cuda(state, pv), reps)
ms[f"ext_omax{omax}"] = cs.cuda_ms(lambda: bc.bucket_step_ext_cuda(pair, aux, False), reps)
ms[f"compact_omax{omax}"] = cs.cuda_ms(lambda: bc.bucket_step_ext_cuda(pair, aux, True), reps)
# the lattice the headless editor sends (1024x1024 at 1.1 r0 over 0.6 of the box)
lat = Simulator(device=dev)
lat.load_frame(_scene(1024, 1024, distance_factor=1.1, speed=0.0, box_fill=0.6, dt=1e-14))
shape = "x".join(str(v) for v in lat.state.x.shape)
ms[f"classic_lattice_{shape}"] = cs.cuda_ms(lambda: bc.bucket_step_cuda(lat.state, lat._pvec), reps)
ms[f"dest_lattice_{shape}"] = cs.cuda_ms(lambda: bc.move_dest_cuda(lat.state), reps)
print("RESULT " + json.dumps(ms))
'''


def main(argv: list[str]) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    here = os.getcwd()
    other = os.path.abspath(argv[0])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for label, root in (("A", other), ("B", here), ("B", here), ("A", other)):
        proc = subprocess.run([sys.executable, "-c", TURN], cwd=root, capture_output=True,
                              text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode or not lines:
            print(f"turn {label} ({root}) failed:\n{proc.stderr[-3000:]}", file=sys.stderr)
            return 1
        print(json.dumps({"checkout": label, "root": root,
                          "ms": json.loads(lines[0][len("RESULT "):])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
