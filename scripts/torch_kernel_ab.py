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
step and the dest on the editor's 1024x1024 lattice (a 512x512x16 grid),
and the live-tile step on the benchmark's 1M lattice (``editor-lattice-1m``'s
1024x1024x16 grid) after 300 and 900 frames served under a cursor drag.
Every phase also holds each kernel against its plain version. A turn prints
one JSON line of kernel times in ms; the card's ``nvidia-smi`` name and power
limit come first. Then two lines: whether the live-tile step's outputs on
those states (and on the user scene's two) are the same bytes in every turn
of both checkouts, and whether the SASS (``cuobjdump -sass``) of the classic,
halo and both tile-scheduled step kernels is the same in both checkouts'
libraries. Exits non-zero when a turn fails or the outputs differ.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TURN = r'''
import hashlib
import json
import math
import chip_smoke as cs
from particle_simulator_tpu_torch.io.frame import Frame
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
digest = {}


def held(label, state, aux):
    """the live-tile step's output on ``state``, as a digest of its bytes"""
    out = bc.bucket_step_ext_cuda(bc.ext_pair(state), aux, True).cur
    digest[label] = hashlib.sha256(b"".join(a.cpu().numpy().tobytes() for a in out)).hexdigest()


held(f"compact_omax{omax}", state, aux)
held(f"compact_omax{user['omax']}", sim.state, bucket.ext_step_aux(sim.state, pv, sim._lane_chunks, 8))
# the benchmark's 1M lattice (a 1024x1024x16 grid) served under a cursor drag:
# the live-tile step as the served cell runs it, once the lattice has spread
drag = Simulator(device=dev)
drag.load_frame(cs.user_scene(1024))
rows = max(1, 1 << max(0, int(drag.meta_record["gpu_threads_per_block_log2"]) - 4))
served = 0
for target in (300, 900):
    while served < target:
        angle = 2 * math.pi * served / 140
        edit = Frame.from_metadata(drag.meta_record.copy())
        edit.metadata.cursor_pos = (0.5 + 0.25 * math.cos(angle), 0.5 + 0.25 * math.sin(angle))
        edit.metadata.cursor_size = 0.05
        drag.update_metadata(edit)
        drag.frame_async()
        served += 1
    aux = bucket.ext_step_aux(drag.state, drag._pvec, drag._lane_chunks, rows)
    pair = bc.ext_pair(drag.state)
    label = f"compact_drag{target}_omax{int(aux.params[-1])}"
    ms[label] = cs.cuda_ms(lambda: bc.bucket_step_ext_cuda(pair, aux, True), reps)
    held(label, drag.state, aux)
ms["digest"] = digest
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
    digests = {}
    for label, root in (("A", other), ("B", here), ("B", here), ("A", other)):
        proc = subprocess.run([sys.executable, "-c", TURN], cwd=root, capture_output=True,
                              text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode or not lines:
            print(f"turn {label} ({root}) failed:\n{proc.stderr[-3000:]}", file=sys.stderr)
            return 1
        ms = json.loads(lines[0][len("RESULT "):])
        digests.setdefault(label, []).append(ms.pop("digest"))
        print(json.dumps({"checkout": label, "root": root, "ms": ms}), flush=True)
    # the live-tile step's outputs, the same bytes in every turn of both checkouts
    same = all(d == digests["A"][0] for turns in digests.values() for d in turns)
    print(json.dumps({"live_tile_step_bit_identical": same, "states": sorted(digests["A"][0])}),
          flush=True)
    sass = {root: sass_functions(root) for root in (other, here)}
    print(json.dumps({"sass_unchanged": {k: sass[other].get(k) == sass[here].get(k)
                                         for k in SASS_KERNELS}}), flush=True)
    return 0 if same else 1


# kernels whose SASS the comparison reads in both checkouts' libraries
SASS_KERNELS = ("bucket_step_kernel<0>", "bucket_step_kernel<1>", "bucket_step_kernel_tiles<0>",
                "bucket_step_kernel_tiles<1>")


def sass_functions(root: str) -> dict:
    """kernel name -> its SASS (``cuobjdump -sass``) in the library a turn
    built under ``root``"""
    import re

    import chip_smoke
    from particle_simulator_tpu_torch.ops import build

    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    lib = os.path.join(root, "particle_simulator_tpu_torch", "build", build.LIB_NAME)
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for func in re.split(r"\n\s*Function : ", text)[1:]:
        name, body = func.split("\n", 1)
        # the instructions and their encodings, without the listing's column padding
        out[chip_smoke.kernel_name(name.strip())] = " ".join(body.split(".....")[0].split())
    return out


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
