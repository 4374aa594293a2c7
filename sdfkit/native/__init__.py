"""Native (C++) host kernels, loaded via ctypes.

The device compute path is JAX/XLA/Pallas; the host runtime around it — here
the marching-cubes sparse phase's welding and normal accumulation — is C++
(sparse_phase.cc, mc_host.cc), compiled on first use with the system g++ into
a shared library next to the source, keyed by a hash of the sources, flags
and host (plain C ABI + numpy ctypes pointers). Everything degrades gracefully: if no compiler is
available the numpy implementations in mesh/marching_cubes.py are used and
results stay correct (welding is bitwise-identical either way).
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import platform
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRCS = [
    os.path.join(_DIR, "sparse_phase.cc"),
    os.path.join(_DIR, "mc_host.cc"),
]
_HDRS = [os.path.join(_DIR, "_mc_luts.h")]
_BASE_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
# -march=native matters: the bitmap/rank corner index does two popcounts per
# lookup, and without it __builtin_popcountll lowers to a libgcc call.
_NATIVE_FLAGS = ["-march=native"]


def _host_id() -> str:
    """What a -march=native build depends on: the machine and the CPU's
    feature flags (a library built for another CPU can hold illegal
    instructions)."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((l for l in f if l.startswith("flags")), "")
    except OSError:
        pass
    return f"{platform.machine()}|{platform.processor()}|{flags}"


def _build_key(srcs, hdrs, flags) -> str:
    h = hashlib.sha256()
    for p in list(srcs) + list(hdrs):
        with open(p, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    h.update(_host_id().encode())
    return h.hexdigest()[:16]


def _build(srcs=_SRCS, hdrs=_HDRS, out_dir=_DIR, name="_sparse_phase"):
    """Compile ``srcs`` into ``out_dir/name.<key>.so`` unless that file
    exists; None on failure. The key hashes the sources, the flags and the
    host, so a library is only ever reused for the exact sources it was built
    from on a CPU like this one. Other builds of ``name`` are removed."""
    try:
        for flags in (_BASE_FLAGS + _NATIVE_FLAGS, _BASE_FLAGS):
            lib = os.path.join(
                out_dir, f"{name}.{_build_key(srcs, hdrs, flags)}.so"
            )
            if os.path.exists(lib):
                return lib
            # Per-process tmp name + atomic rename: concurrent first-use
            # builds (pytest workers, bench + tests) each compile their own
            # file and the last rename wins with a complete library.
            tmp = f"{lib}.{os.getpid()}.tmp"
            try:
                subprocess.run(
                    ["g++", *flags, *srcs, "-o", tmp],
                    check=True, capture_output=True, timeout=120,
                )
            except subprocess.CalledProcessError:
                continue  # toolchain rejects the flags: try portable ones
            os.replace(tmp, lib)
            for stale in glob.glob(os.path.join(out_dir, f"{name}*.so")):
                if stale != lib:
                    with contextlib.suppress(OSError):
                        os.unlink(stale)
            return lib
        return None
    except Exception:
        return None


def _load():
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.weld_i64.restype = ctypes.c_int64
        lib.weld_i64.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.grad_edges.restype = None
        lib.grad_edges.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_double, ctypes.c_void_p,
        ]
        lib.decode_bits_i64.restype = ctypes.c_int64
        lib.decode_bits_i64.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.decode_bits_sparse_i64.restype = ctypes.c_int64
        lib.decode_bits_sparse_i64.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.mc_sparse_index.restype = ctypes.c_void_p
        lib.mc_sparse_index.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,          # active, n_active
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # lx, ly, lz
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # nx, ny, nz
            ctypes.c_int64, ctypes.c_double,          # step, iso
        ]
        lib.mc_set_geo_workers.restype = None
        lib.mc_set_geo_workers.argtypes = [ctypes.c_int32]
        lib.mc_sparse_pvals_chunk.restype = ctypes.c_int64
        lib.mc_sparse_pvals_chunk.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.mc_sparse_expected_points.restype = ctypes.c_int64
        lib.mc_sparse_expected_points.argtypes = [ctypes.c_void_p]
        lib.mc_sparse_expected_points_below.restype = ctypes.c_int64
        lib.mc_sparse_expected_points_below.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.mc_sparse_geometry.restype = ctypes.c_int32
        lib.mc_sparse_geometry.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,           # cell range [start, end)
            ctypes.c_void_p,                          # counts out (4)
        ]
        lib.mc_sparse_color_inputs.restype = None
        lib.mc_sparse_color_inputs.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ] + [ctypes.c_void_p] * 5
        lib.mc_sparse_grad_finalize.restype = None
        lib.mc_sparse_grad_finalize.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.mc_sparse_free.restype = None
        lib.mc_sparse_free.argtypes = [ctypes.c_void_p]
        lib.mc_sequential_baseline.restype = ctypes.c_int64
        lib.mc_sequential_baseline.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_double, ctypes.c_void_p,
        ]
        return lib
    except OSError:
        return None


_lib = _load()


def available() -> bool:
    return _lib is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def weld(keys: np.ndarray):
    """Vertex welding (see sparse_phase.cc weld_i64). Returns
    (vertex_id int64 (n,), rep int64 (n_verts,)) — bitwise identical to the
    numpy np.unique + first-occurrence-rank chain."""
    keys = np.ascontiguousarray(keys, np.int64)
    n = keys.shape[0]
    vertex_id = np.empty(n, np.int32)
    rep = np.empty(n, np.int64)  # upper bound; trimmed below
    n_verts = _lib.weld_i64(_ptr(keys), n, _ptr(vertex_id), _ptr(rep))
    return vertex_id.astype(np.int64), rep[:n_verts]


def grad_edges(evi, ecell, vid, v8, vg, normals, eps: float) -> None:
    """Accumulate edge-vertex gradient contributions into ``normals``
    (float32 (n_verts, 3)), in place. See sparse_phase.cc grad_edges."""
    from sdfkit.mesh import luts

    evi = np.ascontiguousarray(evi, np.uint8)
    ecell = np.ascontiguousarray(ecell, np.int64)
    vid = np.ascontiguousarray(vid, np.int32)
    v8 = np.ascontiguousarray(v8, np.float64)
    vg = np.ascontiguousarray(vg, np.float32)
    assert normals.dtype == np.float32 and normals.flags.c_contiguous
    p1 = np.ascontiguousarray(luts.EDGE_P1, np.int8)
    p2 = np.ascontiguousarray(luts.EDGE_P2, np.int8)
    mc1 = np.ascontiguousarray(luts.EDGE_MC1, np.int8)
    mc2 = np.ascontiguousarray(luts.EDGE_MC2, np.int8)
    _lib.grad_edges(
        _ptr(evi), _ptr(ecell), _ptr(vid), evi.shape[0],
        _ptr(v8), _ptr(vg), v8.shape[1],
        _ptr(p1), _ptr(p2), _ptr(mc1), _ptr(mc2),
        ctypes.c_double(eps), _ptr(normals),
    )


def set_geo_workers(n: int) -> None:
    """Override mc_sparse_geometry's worker-count rule: -1 = auto (direct
    rolling-layer path below 4 hardware threads, threaded worker+merge
    above), 1 = force direct, >= 2 = force threaded with that many workers.
    The parity tests use this to exercise BOTH dedup implementations on any
    host (tests/test_native.py). No-op when the native library is
    unavailable (numpy-fallback hosts keep degrading gracefully)."""
    if _lib is not None:
        _lib.mc_set_geo_workers(int(n))


def decode_bits(words: np.ndarray, count: int) -> np.ndarray:
    """Active-cell indices from the packed uint32 bitmap (mc_host.cc
    decode_bits_i64). ``count`` is the known popcount (from the device count
    sync) and also the output capacity: the C scan stops at the capacity and
    returns -1 instead of overflowing (the bitmap and the count leave the
    device in separate transfers, so a bug could make them disagree). Any
    mismatch raises here before the caller touches the indices."""
    words = np.ascontiguousarray(words, np.uint32)
    out = np.empty(count, np.int64)
    n = _lib.decode_bits_i64(_ptr(words), words.shape[0], _ptr(out), count)
    if n != count:
        raise AssertionError(
            f"bitmap popcount {'exceeds' if n < 0 else 'is'} "
            f"{'capacity' if n < 0 else n} vs device count {count}"
        )
    return out


def decode_bits_sparse(wpos: np.ndarray, wvals: np.ndarray,
                       count: int) -> np.ndarray:
    """Active-cell indices from the TWO-LEVEL bitmap (mc_host.cc
    decode_bits_sparse_i64): ``wpos`` are nonzero-word positions (from
    decode_bits of the level-1 bitmap), ``wvals`` their word values. Same
    capacity/mismatch contract as decode_bits."""
    wpos = np.ascontiguousarray(wpos, np.int64)
    wvals = np.ascontiguousarray(wvals, np.uint32)
    out = np.empty(count, np.int64)
    n = _lib.decode_bits_sparse_i64(
        _ptr(wpos), _ptr(wvals), wpos.shape[0], _ptr(out), count
    )
    if n != count:
        raise AssertionError(
            f"sparse bitmap popcount {'exceeds' if n < 0 else 'is'} "
            f"{'capacity' if n < 0 else n} vs device count {count}"
        )
    return out


class McSparse:
    """Phased C++ sparse geometry (mc_host.cc): ``begin`` runs bitmap/rank
    corner reconstruction + MC33 dispatch + first-occurrence welding + vertex
    interpolation and returns the device color-blend inputs; the caller then
    launches the on-device color blends; ``grad_finalize`` accumulates the
    gradient normals and applies the world-space finalize WHILE the colors
    stream back. Use as:

        mc = McSparse(active, lx, ly, lz, nx, ny, nz, step, iso)  # phase A
        pv = np.asarray(pvals_device)     # ... overlaps phase A
        if mc.ok and mc.geometry(pv, 0, half):          # phase B, chunk 1
            ci1 = mc.color_inputs_since(0, 0)           # blend chunk 1 now
            mc.geometry(None, half, n_active)           # phase B, chunk 2
            ci2 = mc.color_inputs_since(len(ci1[...]))  # blend the rest
            verts, normals, stream = mc.grad_finalize(size3, center3)
        mc.close()
    """

    def __init__(self, active, lx, ly, lz, nx, ny, nz, step, iso):
        """Phase A (corner bitmap/rank index): needs only the active-cell
        ids — construct this WHILE the point values still stream from the
        device, then call .geometry(pvals)."""
        self._active = np.ascontiguousarray(active, np.int64)
        self._handle = _lib.mc_sparse_index(
            _ptr(self._active), self._active.shape[0],
            lx, ly, lz, nx, ny, nz, step, ctypes.c_double(iso),
        )
        self.ok = bool(self._handle)

    def pvals_chunk(self, pvals: np.ndarray) -> int:
        """Append a chunk of the compacted point-value stream (z-major, so
        chunks are contiguous global ranks); returns the stored total. Use
        with geometry(None, start, end) over the cell range whose corner
        points the stored chunks cover, and check expected_points() before
        the final chunk (see _sparse_phase_native)."""
        pv = np.ascontiguousarray(pvals, np.float32)
        # (The C side copies into its own vector before returning.)
        return int(_lib.mc_sparse_pvals_chunk(
            self._handle, _ptr(pv), pv.shape[0]
        ))

    def expected_points(self) -> int:
        """The point count the corner index expects (bitmap rank total)."""
        return int(_lib.mc_sparse_expected_points(self._handle))

    def expected_points_below(self, pid: int) -> int:
        """Corner points the index expects below point id ``pid``."""
        return int(_lib.mc_sparse_expected_points_below(self._handle, pid))

    def geometry(self, pvals, start: int = 0, end: int | None = None) -> bool:
        """Phase B: dispatch + weld + interpolation over cells
        [start, end) — chunks must be called in ascending order (welding
        and vertex ranks persist in the handle, so chunking is
        bit-identical to one pass). ``pvals`` only on the first chunk.
        False on host/device index mismatch (caller falls back to numpy).
        Cumulative counts land in n_verts/stream_len/n_edge/n_center."""
        if pvals is not None:
            self._pvals = np.ascontiguousarray(pvals, np.float32)
            pv_ptr, pv_n = _ptr(self._pvals), self._pvals.shape[0]
        else:
            pv_ptr, pv_n = None, 0
        if end is None:
            end = self._active.shape[0]
        counts = np.zeros(4, np.int64)
        ok = _lib.mc_sparse_geometry(
            self._handle, pv_ptr, pv_n, start, end, _ptr(counts),
        )
        if not ok:
            self.ok = False
            return False
        self.n_verts, self.stream_len, self.n_edge, self.n_center = (
            int(c) for c in counts
        )
        return True

    def color_inputs_since(self, edge_from: int = 0, center_from: int = 0):
        """Device color-blend inputs for edge vertices [edge_from, n_edge)
        and centers [center_from, n_center) discovered so far."""
        ne = self.n_edge - edge_from
        nc = self.n_center - center_from
        ci = {
            "edge_vid": np.empty(ne, np.int32),
            "edge_base": np.empty(ne, np.int32),
            "edge_vi": np.empty(ne, np.uint8),
            "center_vid": np.empty(nc, np.int32),
            "center_base": np.empty(nc, np.int32),
        }
        _lib.mc_sparse_color_inputs(
            self._handle, edge_from, center_from,
            _ptr(ci["edge_vid"]), _ptr(ci["edge_base"]),
            _ptr(ci["edge_vi"]), _ptr(ci["center_vid"]),
            _ptr(ci["center_base"]),
        )
        return ci

    def grad_finalize(self, size3, center3):
        """Returns (verts f32 (V,3) world, normals f32 (V,3), stream i32)."""
        size3 = np.ascontiguousarray(size3, np.float64)
        center3 = np.ascontiguousarray(center3, np.float64)
        verts = np.empty((self.n_verts, 3), np.float32)
        normals = np.empty((self.n_verts, 3), np.float32)
        stream = np.empty(self.stream_len, np.int32)
        _lib.mc_sparse_grad_finalize(
            self._handle, _ptr(size3), _ptr(center3), _ptr(verts),
            _ptr(normals), _ptr(stream),
        )
        return verts, normals, stream

    def close(self):
        # The _lib guard matters for the __del__ backstop: at interpreter
        # shutdown the module globals may already be cleared, and a free
        # through a torn-down CDLL would raise "Exception ignored in
        # __del__" noise (the OS reclaims the memory anyway at that point).
        if getattr(self, "_handle", None) and _lib is not None:
            _lib.mc_sparse_free(self._handle)
            self._handle = None

    # Backstop: the handle owns copies of the active ids, bitmap, rank and
    # vertex arrays (tens of MB at 256^3) — free them even if the caller's
    # explicit close() is skipped by an exception path.
    __del__ = close


def mc_sequential_baseline(values, colors, step: int, iso: float):
    """Single-threaded reference-style marching cubes over the full grid
    (mc_host.cc mc_sequential_baseline) — the measured stand-in for the
    reference's sequential C# meshing loop. Returns (n_verts, stream_len)."""
    values = np.ascontiguousarray(values, np.float32)
    nx, ny, nz = values.shape
    cptr = None
    if colors is not None:
        colors = np.ascontiguousarray(colors, np.float32)
        assert colors.shape == (nx, ny, nz, 3)
        cptr = _ptr(colors)
    counts = np.zeros(1, np.int64)
    n_verts = _lib.mc_sequential_baseline(
        _ptr(values), cptr, nx, ny, nz, step, ctypes.c_double(iso),
        _ptr(counts),
    )
    return int(n_verts), int(counts[0])
