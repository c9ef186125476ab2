#!/usr/bin/env python3
"""Try shapes of the redesigned kernels on one card without touching the
sources: each variant is a patched copy of ``ops/csrc`` (a ``constexpr`` at
the top of a source, a launch bound, or one line of code), built on its own
with the repo's nvcc flags, loaded with ``ctypes`` and called through its
``extern "C"`` entry point on the same tensors as the others.

Run on a machine with one NVIDIA H100, from the repository root, with the
families to try (default: all of ``allpairs tiles step dest``):

    python3 scripts/torch_kernel_variants.py [family ...]

All variants build in parallel (one nvcc each, ~10 s in all) under the
git-ignored ``particle_simulator_tpu_torch/build/variants``. Prints the
card's ``nvidia-smi`` name and power limit, then one JSON line a variant:

- ``allpairs``: the all-pairs step at 16,384 slots (``gas-diffusion-16k``)
  and 2,048 slots (the droplet), each held bit for bit against the plain
  version run with the variant's segment length, then timed (30 launches,
  CUDA events), with ptxas's registers and shared memory;
- ``tiles``: the tile-scheduled step, live tiles only (``compact``) and
  every tile (``ext``), on the 1M user scene (omax 6) and on a denser 1M
  lattice (``fill07``: 512x512x16 grid, omax 12), each held bit for bit
  against the classic CUDA step, then timed; the variant of the sources
  also with 4 and 16 blocks an SM in the launch instead of the wrapper's
  ``TILE_BLOCKS_PER_SM``. ``stage_only`` switches the receiver loop
  off (its result is wrong on purpose): what the stage and the pass-through
  cost alone;
- ``step``: the classic and halo step (``ps_bucket_step``) on the dense
  512x256x8 scene, its four halo-padded shards, the 1M user scene and the
  editor's 1024x1024 lattice (512x512x16), each held bit for bit against the
  repo's own build, then timed: one block a sub-tile (the sources) against
  blocks that stride over the sub-tiles, other block and sub-tile shapes;
- ``dest``: the dest (``ps_bucket_dest``) on the same four states, held
  against the repo's own build, then timed: other block and sub-tile shapes.

A substitution that no longer matches the sources is reported and its
variant skipped. Exits non-zero when a variant that built disagrees.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def allpairs_shape(recv=16, warps=8, seg=128, bound=None):
    subs = [("constexpr int AP_SEGMENT = 128;", f"constexpr int AP_SEGMENT = {seg};"),
            ("constexpr int AP_RECV = 16; ", f"constexpr int AP_RECV = {recv}; "),
            ("constexpr int AP_WARPS = 8; ", f"constexpr int AP_WARPS = {warps}; ")]
    if bound:
        subs.append(("__launch_bounds__(AP_THREADS)", f"__launch_bounds__(AP_THREADS, {bound})"))
    return subs


def tiles_shape(threads=256, rows=8, cols=16, unroll=2, extra=()):
    return [("constexpr int TILE_THREADS = 256;", f"constexpr int TILE_THREADS = {threads};"),
            ("constexpr int TILE_SUB_ROWS = 8;", f"constexpr int TILE_SUB_ROWS = {rows};"),
            ("constexpr int TILE_SUB_COLS = 16;", f"constexpr int TILE_SUB_COLS = {cols};"),
            ("constexpr int PS_RUN_UNROLL = 2;", f"constexpr int PS_RUN_UNROLL = {unroll};"),
            *extra]


TILE_ORDER = "const int tile = COMPACT ? __ldg(order + k) : k;"
TILE_BOUND = "__launch_bounds__(TILE_THREADS) bucket_step_tiles_kernel"
# the pass-through's 16-byte copies with streaming (evict-first) loads and stores
COPIES = [(f"*reinterpret_cast<{t}*>({o} + i) = *reinterpret_cast<const {t}*>({i} + i);",
           f"__stcs(reinterpret_cast<{t}*>({o} + i), "
           f"__ldcs(reinterpret_cast<const {t}*>({i} + i)));")
          for t, o, i in (("uint4", "ox", "x"), ("uint4", "oy", "y"),
                          ("float4", "ovx", "vx"), ("float4", "ovy", "vy"))]


def tile_streams(n):
    """The every-tile walk as ``n`` interleaved streams of neighbouring tiles."""
    return [(TILE_ORDER, f"const int tile = COMPACT ? __ldg(order + k) : (n_visits % {n} ? k : "
                         f"(k % {n}) * (n_visits / {n}) + k / {n});")]


VARIANTS = {
    "allpairs": {
        "recv16_warps8_L128 (the sources)": [],
        "recv32_warps8_L128": allpairs_shape(32, 8),
        "recv32_warps8_L256": allpairs_shape(32, 8, 256),
        "recv16_warps4_L128": allpairs_shape(16, 4),
        "recv8_warps4_L128": allpairs_shape(8, 4),
        "recv16_warps4_L256": allpairs_shape(16, 4, 256),
        "recv32_warps4_L512": allpairs_shape(32, 4, 512),
        "recv16_warps8_L128_5_blocks_an_sm": allpairs_shape(bound=5),
    },
    "tiles": {
        "threads256_sub8x16_unroll2 (the sources)": [],
        "unroll1": tiles_shape(unroll=1),
        "unroll4": tiles_shape(unroll=4),
        "threads128_sub8x8": tiles_shape(128, 8, 8),
        "threads128_sub4x16": tiles_shape(128, 4, 16),
        "6_blocks_an_sm": tiles_shape(extra=[(TILE_BOUND, TILE_BOUND.replace(")", ", 6)", 1))]),
        "stage_only": tiles_shape(extra=[("r < n_recv; r += blockDim.x",
                                          "r < n_recv && g.gy < 0; r += blockDim.x")]),
        "tile_order_stride_633": tiles_shape(extra=[
            (TILE_ORDER, "const int tile = COMPACT ? __ldg(order + k) : "
                         "(n_visits == 1024 ? (int)((long)k * 633 % 1024) : k);")]),
        "tile_streams_4": tiles_shape(extra=tile_streams(4)),
        "tile_streams_16": tiles_shape(extra=tile_streams(16)),
        "streaming_copies": tiles_shape(extra=COPIES),
    },
}


def step_launch(per_sm):
    """``per_sm`` blocks for each of the H100's 132 SMs stride over the
    sub-tiles (the kernel's loop takes any launch), not one block each."""
    count = "(long)ps_blocks(ry, st.rows) * ps_blocks(rx, st.cols) * n_grids;"
    return [(f"  const long blocks = {count}",
             f"  const long subs = {count}\n"
             f"  const long blocks = subs < {per_sm} * 132 ? subs : {per_sm} * 132;")]


def dest_shape(threads=256, rows=8, cols=16):
    return [("constexpr int DEST_THREADS = 256;", f"constexpr int DEST_THREADS = {threads};"),
            ("constexpr int DEST_SUB_ROWS = 8;", f"constexpr int DEST_SUB_ROWS = {rows};"),
            ("constexpr int DEST_SUB_COLS = 16;", f"constexpr int DEST_SUB_COLS = {cols};")]


VARIANTS["step"] = {
    "one_block_a_subtile (the sources)": [],
    "4_blocks_an_sm": step_launch(4),
    "8_blocks_an_sm": step_launch(8),
    "16_blocks_an_sm": step_launch(16),
    "unroll1": tiles_shape(unroll=1),
    "threads128_sub8x8": tiles_shape(128, 8, 8),
    "threads128_sub4x16": tiles_shape(128, 4, 16),
    "threads512_sub16x16": tiles_shape(512, 16, 16),
    "copy_even_when_all_live": [("if (n_recv < g.in_rows * g.in_cols * cap) {", "{")],
}
VARIANTS["dest"] = {
    "threads256_sub8x16 (the sources)": [],
    "threads128_sub8x16": dest_shape(128),
    "threads512_sub8x16": dest_shape(512),
    "threads128_sub4x16": dest_shape(128, 4, 16),
    "threads256_sub8x32": dest_shape(256, 8, 32),
    "threads256_sub16x16": dest_shape(256, 16, 16),
    "threads512_sub16x32": dest_shape(512, 16, 32),
    "threads1024_sub16x32": dest_shape(1024, 16, 32),
    # (bucket, slot) of a thread's next slot by a division instead of an advance
    "division_per_slot": [("b += b_step, s += s_step;",
                           "b = (i + blockDim.x) / cap, s = i + blockDim.x - b * cap;"),
                          ("if (s >= cap) ++b, s -= cap;", "")],
}
SOURCE = {"allpairs": "allpairs_step.cu", "tiles": "bucket_step.cu", "step": "bucket_step.cu",
          "dest": "bucket_dest.cu"}
KERNEL = {"allpairs": "allpairs_step_kernel", "tiles": "bucket_step_tiles_kernel<1>",
          "step": "bucket_step_kernel<0>", "dest": "bucket_dest_kernel<0>"}


def start_builds(out_dir, families):
    """One patched copy and one nvcc per variant of ``families``; (family,
    name, dir, process)."""
    from particle_simulator_tpu_torch.ops import build

    nvcc = build.find_nvcc()
    started = []
    for family in families:
        for name, subs in VARIANTS[family].items():
            d = os.path.join(out_dir, family, name.split(" ")[0])
            shutil.rmtree(d, ignore_errors=True)
            shutil.copytree(build.CSRC, d)
            texts = {fn: open(os.path.join(d, fn)).read() for fn in os.listdir(d)}
            missed = [old for old, new in subs if old != new
                      and not any(old in t for t in texts.values())]
            if missed:
                print(json.dumps({"family": family, "variant": name,
                                  "skipped": "substitution missed", "text": missed[0]}),
                      flush=True)
                continue
            for fn, text in texts.items():
                for old, new in subs:
                    text = text.replace(old, new)
                with open(os.path.join(d, fn), "w") as f:
                    f.write(text)
            cmd = [nvcc, *build.NVCC_FLAGS, "-shared", "-o", os.path.join(d, "lib.so"),
                   os.path.join(d, SOURCE[family])]
            started.append((family, name, d, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    return started


def grid_states(dev):
    """label -> (state, params vector, (bx_log2, by_log2), shard offsets or
    None, ring) of the step and dest families' four states."""
    import chip_smoke as cs
    from particle_simulator_tpu_torch.engine.simulator import Simulator
    from particle_simulator_tpu_torch.engine.state import SimParams, state_from_numpy
    from particle_simulator_tpu_torch.parallel import domain
    from particle_simulator_tpu_torch.physics.bucket import GridConfig

    cfg = GridConfig(8, 9, 8)
    parts, meta, _ = cs.dense_grid_scene(cfg)
    dense = state_from_numpy(parts, cfg.capacity, dev).reshape(cfg.grid_shape)
    pv = SimParams.from_record(meta).vector(dev)
    log2 = (cfg.bx_log2, cfg.by_log2)
    mesh = cs.one_card_mesh(dev)
    (padded,) = domain.exchange_halo(domain.shard_state(dense, mesh), mesh)
    (offsets,) = domain.ring_plan(mesh, padded.x.shape[1] - 2, padded.x.shape[2] - 2).offsets
    cases = {"dense": (dense, pv, log2, None, 0), "dense_halo": (padded, pv, log2, offsets, 1)}
    for label, scene in (("user", cs.user_scene()), ("editor_lattice", cs.editor_lattice())):
        sim = Simulator(device=dev)
        sim.load_frame(scene)
        cases[label] = (sim.state, sim._pvec, (sim.grid.bx_log2, sim.grid.by_log2), None, 0)
    return cases


def main(argv: list[str]) -> int:
    import torch

    import chip_smoke as cs
    from particle_simulator_tpu_torch.engine.simulator import Simulator
    from particle_simulator_tpu_torch.ops import build
    from particle_simulator_tpu_torch.ops import bucket_cuda as bc
    from particle_simulator_tpu_torch.physics import bucket, step
    from particle_simulator_tpu_torch.scenes.library import _scene, gas_diffusion, liquid_droplet

    families = argv or list(VARIANTS)
    if any(f not in VARIANTS for f in families):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    started = start_builds(os.path.join(build.BUILD_DIR, "variants"), families)
    build.library()  # the repo's own library: the classic step the tiles are held against
    dev, reps = "cuda", 30
    ptr, integer = ctypes.c_void_p, ctypes.c_int

    def stream():
        return torch.cuda.current_stream().cuda_stream

    ap_cases = {"16384": cs.compact_state(gas_diffusion(), dev),
                "2048": cs.compact_state(liquid_droplet(), dev)} if "allpairs" in families else {}
    ap_refs = {}
    tile_cases = {}
    for label, scene in (("user", cs.user_scene()),
                         ("fill07", _scene(1024, 1024, distance_factor=1.1, speed=1.0,
                                          box_fill=0.7))):
        if "tiles" not in families:
            break
        sim = Simulator(device=dev)
        sim.load_frame(scene)
        aux = bucket.ext_step_aux(sim.state, sim._pvec, sim._lane_chunks, 8)
        tile_cases[label] = (sim.state, aux, bc.bucket_step_cuda(sim.state, sim._pvec))
        print(json.dumps({"scene": label, "grid": list(sim.state.x.shape),
                          "omax": int(aux.params[-1]), "live_tiles": cs.live_tile_share(aux),
                          "classic_ms": cs.cuda_ms(
                              lambda: bc.bucket_step_cuda(sim.state, sim._pvec), reps)}),
              flush=True)
    grid_cases = grid_states(dev) if {"step", "dest"} & set(families) else {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    budget = bc.TILE_BLOCKS_PER_SM * sms

    failed = False
    for family, name, d, proc in started:
        err = proc.communicate()[1]
        line = {"family": family, "variant": name}
        if proc.returncode:
            print(json.dumps({**line, "build_failed": err[-600:]}), flush=True)
            continue
        line["ptxas"] = cs.ptxas_summary(err).get(KERNEL[family])
        lib = ctypes.CDLL(os.path.join(d, "lib.so"))
        if family == "allpairs":
            lib.ps_allpairs_step.argtypes = [ptr] * 10 + [integer, ptr]
            line["L"] = step.SEGMENT = lib.ps_allpairs_segment()
            for label, (state, pv, _) in ap_cases.items():
                out = [torch.empty_like(a) for a in state[:4]]

                def call():
                    rc = lib.ps_allpairs_step(*(a.data_ptr() for a in state), pv.data_ptr(),
                                              *(o.data_ptr() for o in out), state.capacity,
                                              stream())
                    assert rc == 0, rc

                call()
                if (label, step.SEGMENT) not in ap_refs:
                    ap_refs[label, step.SEGMENT] = step.allpairs_step(state, pv)
                same = all(torch.equal(a, b)
                           for a, b in zip(out, ap_refs[label, step.SEGMENT][:4]))
                failed |= not same
                line[label] = {"bit_identical": same, "ms": cs.cuda_ms(call, reps)}
        elif family == "step":
            lib.ps_bucket_step.argtypes = [ptr] * 10 + [integer] * 5 + [ptr]
            for label, (state, pv, _, _, ring) in grid_cases.items():
                *lead, gy, gx, cap = state.x.shape
                n = lead[0] if lead else 1
                out = [torch.empty_like(a) for a in state[:4]]

                def call():
                    rc = lib.ps_bucket_step(*(a.data_ptr() for a in state), pv.data_ptr(),
                                            *(o.data_ptr() for o in out), n, gy, gx, cap, ring,
                                            stream())
                    assert rc == 0, rc

                call()
                ref = (bc.bucket_step_halo_cuda if ring else bc.bucket_step_cuda)(state, pv)
                same = all(torch.equal(a, b) for a, b in zip(out, ref[:4]))
                failed |= not same
                line[label] = {"bit_identical": same, "ms": cs.cuda_ms(call, reps)}
        elif family == "dest":
            lib.ps_bucket_dest.argtypes = [ptr] * 5 + [integer] * 7 + [ptr]
            for label, (state, _, log2, offsets, ring) in grid_cases.items():
                *lead, gy, gx, cap = state.x.shape
                n = lead[0] if lead else 1
                out = torch.empty_like(state.ty)

                def call():
                    rc = lib.ps_bucket_dest(state.x.data_ptr(), state.y.data_ptr(),
                                            state.ty.data_ptr(),
                                            offsets.data_ptr() if ring else None, out.data_ptr(),
                                            n, gy, gx, cap, *log2, ring, stream())
                    assert rc == 0, rc

                call()
                ref = (bc.move_dest_halo_cuda(state, *log2, offsets) if ring
                       else bc.move_dest_cuda(state))
                same = torch.equal(out, ref)
                failed |= not same
                line[label] = {"bit_identical": same, "ms": cs.cuda_ms(call, reps)}
        else:
            lib.ps_bucket_step_tiles.argtypes = [ptr] * 13 + [integer] * 7 + [ptr]
            for label, (state, aux, classic) in tile_cases.items():
                by, bx, cap = state.x.shape
                for compact in (True, False):
                    out = [a.clone() if compact else torch.empty_like(a) for a in state[:4]]

                    def call(blocks=budget):
                        rc = lib.ps_bucket_step_tiles(
                            *(a.data_ptr() for a in state), *(t.data_ptr() for t in aux[:4]),
                            *(o.data_ptr() for o in out), by, bx, cap, aux.ty_rows,
                            aux.lane_chunks, int(compact), blocks, stream())
                        assert rc == 0, rc

                    call()
                    same = all(torch.equal(a, b) for a, b in zip(out, classic[:4]))
                    failed |= not same and name != "stage_only"
                    mode = f"{label}_{'compact' if compact else 'ext'}"
                    line[mode] = {"bit_identical": same, "ms": cs.cuda_ms(call, reps)}
                    if not VARIANTS[family][name]:  # the sources' own shape
                        for per_sm in (4, 16):
                            line[mode][f"ms_{per_sm}_blocks_an_sm"] = cs.cuda_ms(
                                lambda: call(per_sm * sms), reps)
        print(json.dumps(line), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
