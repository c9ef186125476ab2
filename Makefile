# Top-level build/run entry points (the reference drives everything through
# cuda_simulator/Makefile + SLURM scripts; here the equivalents are make
# targets — there is no cluster scheduler dependency).

PY ?= python
CPU_ENV = JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8

.PHONY: all native test bench daemon editor dryrun clean \
	torch-bench torch-daemon torch-editor torch-dryrun

all: native test

native:
	$(MAKE) -C native

test:
	$(PY) -m pytest tests/ -q

bench:
	$(PY) bench.py

# engine daemon (connects to the editor's TCP server)
daemon:
	$(PY) -m particle_simulator_tpu.engine.daemon --addr 127.0.0.1:53123

# headless editor session (TCP server; sends a lattice, collects frames)
editor:
	$(PY) -m particle_simulator_tpu.editor.headless --frames 20

# multi-chip sharding dry run on a virtual 8-device CPU mesh
dryrun:
	$(CPU_ENV) $(PY) -c "import __graft_entry__ as g; g.dryrun_multichip(8); print('dryrun OK')"

# the PyTorch + CUDA port (particle_simulator_tpu_torch): the same entry
# points. The bench and the daemon run on an NVIDIA card and raise without
# one (run their modules with --torch-device cpu for the CPU); the editor is
# numpy only. The dry run here is on the CPU (the plain versions); on a card,
# dryrun_multichip(8) holds the halo kernels against the classic ones.
torch-bench:
	$(PY) -m particle_simulator_tpu_torch.bench

torch-daemon:
	$(PY) -m particle_simulator_tpu_torch.engine.daemon --addr 127.0.0.1:53123

torch-editor:
	$(PY) -m particle_simulator_tpu_torch.editor.headless --frames 20

# the sharded frame on an 8-shard CPU mesh, bit for bit against one device
torch-dryrun:
	$(PY) -c "from particle_simulator_tpu_torch.entry import dryrun_multichip; dryrun_multichip(8, device='cpu'); print('dryrun OK')"

clean:
	$(MAKE) -C native clean
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true
