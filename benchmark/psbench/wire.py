"""The frozen wire format of the editor link, decoded and encoded here.

A packet is a 96-byte header (start signature ``36 bc e9 bd``, u32 particle
count, 80 bytes of metadata, end signature ``ac c4 12 ec``, 4 bytes of
padding) and ``count`` particles of 20 bytes (u32 x, u32 y, f32 vx, f32 vy,
i32 ty), little-endian (upstream ``particle_io/src/particle.rs``). A packet
without particles is a live metadata edit; one with particles resets the
scene.
"""

from __future__ import annotations

import numpy as np

MIE_DTYPE = np.dtype([("sigma", "<f4"), ("epsilon", "<f4"), ("n", "<f4"), ("m", "<f4")])
METADATA_DTYPE = np.dtype([
    ("particles", MIE_DTYPE, (2,)),
    ("cursor_pos", "<f4", (2,)),
    ("cursor_size", "<f4"),
    ("step_dt", "<f4"),
    ("steps_per_frame", "<u4"),
    ("box_width", "<f4"),
    ("box_height", "<f4"),
    ("data_structure", "<u4"),
    ("device", "<u4"),
    ("gpu_threads_per_block_log2", "<u4"),
    ("_padding", "<u4", (2,)),
])
HEADER_DTYPE = np.dtype([
    ("signature_start", "u1", (4,)),
    ("particle_count", "<u4"),
    ("metadata", METADATA_DTYPE),
    ("signature_end", "u1", (4,)),
    ("_padding", "<u4"),
])
PARTICLE_DTYPE = np.dtype([("x", "<u4"), ("y", "<u4"), ("vx", "<f4"), ("vy", "<f4"),
                           ("ty", "<i4")])
HEADER_SIZE = HEADER_DTYPE.itemsize
PARTICLE_SIZE = PARTICLE_DTYPE.itemsize
SIGNATURE_START = bytes([0x36, 0xBC, 0xE9, 0xBD])
SIGNATURE_END = bytes([0xAC, 0xC4, 0x12, 0xEC])

BOLTZMANN = 1.380649e-23
# (sigma, epsilon, n, m) of the editor's two default species
NITROGEN = (3.609e-10, 105.79 * BOLTZMANN, 14.08, 6.0)
ARGON = (3.404e-10, 117.84 * BOLTZMANN, 12.085, 6.0)
COMPACT_ARRAY, MATRIX_BUCKETS, GPU = 0, 1, 0  # upstream particle.rs:52-78


def force0_r(species) -> float:
    """Equilibrium distance of a species (f64): sigma * (n/m)^(1/(n-m))."""
    sigma, _, n, m = (float(v) for v in species)
    return sigma * (n / m) ** (1.0 / (n - m))


def default_metadata() -> np.ndarray:
    """The editor's default metadata (upstream ``FrameMetadata::default``):
    Nitrogen and Argon, dt 50 fs, 100 steps a frame, a 50 nm box,
    MatrixBuckets on the GPU, the cursor off at (-1, -1), size 0.05."""
    meta = np.zeros((), dtype=METADATA_DTYPE)
    meta["particles"][0] = NITROGEN
    meta["particles"][1] = ARGON
    meta["cursor_pos"] = (-1.0, -1.0)
    meta["cursor_size"] = 0.05
    meta["step_dt"] = 50e-15
    meta["steps_per_frame"] = 100
    meta["box_width"] = 50e-9
    meta["box_height"] = 50e-9
    meta["data_structure"] = MATRIX_BUCKETS
    meta["device"] = GPU
    meta["gpu_threads_per_block_log2"] = 7
    return meta


def header(meta: np.ndarray, count: int) -> bytes:
    hdr = np.zeros((), dtype=HEADER_DTYPE)
    hdr["signature_start"] = np.frombuffer(SIGNATURE_START, np.uint8)
    hdr["signature_end"] = np.frombuffer(SIGNATURE_END, np.uint8)
    hdr["particle_count"] = count
    hdr["metadata"] = meta
    return hdr.tobytes()


def encode(meta: np.ndarray, parts: np.ndarray | None = None) -> bytes:
    """One packet: ``meta`` and the particles (none = a metadata edit)."""
    if parts is None or len(parts) == 0:
        return header(meta, 0)
    body = np.ascontiguousarray(parts, dtype=PARTICLE_DTYPE)
    return header(meta, len(body)) + body.tobytes()


def decode_header(raw) -> tuple[int, np.ndarray]:
    """(particle count, metadata record) of a 96-byte header; raises on a
    bad signature."""
    hdr = np.frombuffer(raw, dtype=HEADER_DTYPE, count=1)[0]
    if (hdr["signature_start"].tobytes() != SIGNATURE_START
            or hdr["signature_end"].tobytes() != SIGNATURE_END):
        raise ValueError("a packet with a bad signature")
    return int(hdr["particle_count"]), hdr["metadata"].copy()


def from_fields(fields) -> np.ndarray:
    """Particles of the wire's dtype from a mapping of its five field
    arrays (``x``, ``y`` as any 32-bit integer, bit for bit)."""
    out = np.zeros(len(fields["x"]), dtype=PARTICLE_DTYPE)
    for name in PARTICLE_DTYPE.names:
        out[name] = np.asarray(fields[name]).view(PARTICLE_DTYPE[name])
    return out


def particles(packet) -> np.ndarray:
    """The particles of a whole packet (a view)."""
    return np.frombuffer(packet, dtype=PARTICLE_DTYPE, offset=HEADER_SIZE)
