"""Lewiner MC33 marching cubes with color interpolation.

Reference: SdfKit/MarchingCubes.cs + Cell.cs + Luts.cs (ported there from
scikit-image's _marching_cubes_lewiner_cy.pyx). Behavior reproduced exactly —
same case/subcase dispatch with face/internal ambiguity tests in float64
(FLT_EPSILON = 1e-7, MarchingCubes.cs:37), same inverse-|value| vertex and
color interpolation (Cell.cs:272-359), same per-reference gradient
accumulation into normals (including the reference's packed-index/MC-corner
vg indexing quirk, Cell.cs:453-498), same first-occurrence vertex ordering —
so the reference's golden vertex counts transfer.

Architecture (device/host split): the dense O(n^3) work — SDF evaluation
(ops/grid.py), per-cell case classification, and active-cell compaction +
corner gathers — runs ON DEVICE in z-slabs, so the only device→host transfer
is O(surface): the active cells' flat indices, case bytes, 8 corner values
and 8 corner colors. The sparse O(surface) work — case dispatch, vertex
welding via canonical edge keys, gradient scatter-add — is vectorized numpy
on host, replacing the reference's strictly sequential per-cell loop and
rolling face-layer dedup (MarchingCubes.cs:53-80, Cell.cs:123-143) with
grouped array ops. The sequential face-layer trick exists only to keep the
dedup table small; the canonical-key formulation is order-free and parallel.
Progress fires per z-slab DURING the dense sweep (the reference reports once
per z layer inside its loop, MarchingCubes.cs:81).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from sdfkit.mesh import luts
from sdfkit.mesh.mesh import Mesh

FLT_EPSILON = 1e-7  # MarchingCubes.cs:37, Cell.cs:63

# z-slab count for the device dense sweep. Each slab is one classify + one
# compact/gather dispatch and one progress burst; 8 keeps dispatch overhead
# negligible while giving live progress at useful granularity.
N_PROGRESS_SLABS = 8


def _native():
    """The C++ host kernels (sdfkit/native), or None to use the numpy
    fallbacks. SDFKIT_NO_NATIVE=1 forces numpy (used by the parity
    tests, and an escape hatch on hosts without g++)."""
    import os

    if os.environ.get("SDFKIT_NO_NATIVE"):
        return None
    try:
        from sdfkit import native
    except Exception:
        return None
    return native if native.available() else None


@partial(jax.jit, static_argnums=(3, 4, 5, 6))
def _classify_slab(values, iso, z0_grid, step: int, lx: int, ly: int, m: int):
    """Dense phase (on device): MC case byte of every cell in a z-slab of
    ``m`` cell layers starting at grid z ``z0_grid``.

    Eight strided slices of the value grid replace per-cell corner gathers —
    one streaming pass, no index arrays (the reference classifies per cell
    inside its triple loop, MarchingCubes.cs:53-80). The predicate
    ``value > iso`` in f32 is exact (both operands are representable),
    matching the reference's ``v - iso > 0`` computed in double (f32→f64 is
    lossless and the f64 subtraction of two f32 values is exact).

    Returns (case bytes flat in (z, y, x) cell order, active mask).
    """
    nx, ny, nz = values.shape
    zext = m * step + 1  # corners reach z0 + (m-1)*step + step
    sub = jax.lax.dynamic_slice(values, (0, 0, z0_grid), (nx, ny, zext))
    bits = jnp.zeros((lx, ly, m), jnp.uint8)
    for k in range(8):
        dx = int(luts.CORNER_DX[k]) * step
        dy = int(luts.CORNER_DY[k]) * step
        dz = int(luts.CORNER_DZ[k]) * step
        corner = jax.lax.slice(
            sub,
            (dx, dy, dz),
            (dx + (lx - 1) * step + 1, dy + (ly - 1) * step + 1,
             dz + (m - 1) * step + 1),
            (step, step, step),
        )  # (lx, ly, m): value at corner k of every cell in the slab
        bits = bits + jnp.uint8(1 << k) * (corner > iso).astype(jnp.uint8)
    bits = bits.transpose(2, 1, 0).reshape(-1)  # reference (z, y, x) order
    # A cell is active iff its corner signs are mixed — case 0 corresponds to
    # bits 0 and 255 exactly (luts.cases[:,0]==0 there and only there), so
    # the mask is two compares instead of a 16.7M-element LUT gather.
    mask = (bits != jnp.uint8(0)) & (bits != jnp.uint8(255))
    return bits, mask


@partial(jax.jit, static_argnums=(1, 2, 3))
def _point_mask(mask, lx: int, ly: int, lz: int):
    """Dilate the flat (z, y, x)-ordered active-cell mask to the mask of
    UNIQUE corner grid points (point grid (lz+1, ly+1, lx+1), flat z-major):
    point p is set iff any of the up-to-8 cells it corners is active. The
    device phase ships the values of exactly these points — ~4x fewer bytes
    than an 8-corner-per-cell stream, and the host rebuilds the per-cell
    corner values from them (mc_host.cc mc_sparse_run)."""
    m3 = mask.reshape(lz, ly, lx)
    pm = jnp.zeros((lz + 1, ly + 1, lx + 1), bool)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                pm = pm | jnp.pad(
                    m3, ((dz, 1 - dz), (dy, 1 - dy), (dx, 1 - dx))
                )
    return pm.reshape(-1)


@partial(jax.jit, static_argnums=(3,))
def _counts_split(mask, pmask, words, p_splits: tuple):
    """The ONE dense-phase sync: active-cell count, unique-point count, the
    nonzero-word count of the packed cell bitmap (sizes the two-level
    bitmap transfer), and the unique-point count BELOW each internal
    z-split boundary (sizes the chunks of the pipelined point-value
    transfer — see _sparse_phase_native)."""
    return jnp.stack(
        [
            jnp.sum(mask.astype(jnp.int32)),
            jnp.sum(pmask.astype(jnp.int32)),
            jnp.sum((words != 0).astype(jnp.int32)),
        ]
        + [jnp.sum(pmask[:p].astype(jnp.int32)) for p in p_splits]
    )


@jax.jit
def _pack_bits(mask):
    """Pack the flat cell mask into uint32 words (bit k of word w =
    mask[w*32 + k]). The host decodes active-cell indices from this 1
    bit/cell stream with a ctz scan (mc_host.cc decode_bits_i64) — shipping
    the bitmap replaces an on-device cumsum+searchsorted compaction that
    cost 91 ms at 16.6M cells with a ~10 ms multiply-reduce pack."""
    n = mask.shape[0]
    pad = (-n) % 32
    m = jnp.pad(mask, (0, pad)).reshape(-1, 32).astype(jnp.uint32)
    return jnp.sum(
        m << jnp.arange(32, dtype=jnp.uint32), axis=1, dtype=jnp.uint32
    )


@partial(jax.jit, static_argnums=(1,))
def _compact_nonzero_words(words, bucket: int):
    """Two-level bitmap compaction (on device): at surface densities ~98% of
    the packed cell-bitmap words are zero, so shipping the dense word stream
    (2 MB at 256^3) wastes the device-to-host link. Ship instead
    (a) a level-1 bitmap marking the NONZERO words (1 bit/word: 64 KB) and
    (b) the nonzero words themselves, compacted in order (~0.2-0.4 MB at
    real surface densities) — a ~5x cut of the dominant dense-phase
    transfer. The host reconstructs word positions from (a) with the same
    ctz scan it already uses for cells, then decodes (b)
    (decode_bits_sparse in mc_host.cc)."""
    nz = words != 0
    l1 = _pack_bits(nz)
    pos = jnp.where(nz, jnp.cumsum(nz.astype(jnp.int32)) - 1, bucket)
    out = jnp.zeros((bucket + 1,), jnp.uint32)
    return l1, out.at[pos].set(words, mode="drop")[:bucket]


@partial(jax.jit, static_argnums=(2, 3, 4, 5, 6, 7, 8))
def _scatter_point_values(values, pmask, step: int, lx: int, ly: int,
                          lz: int, psize: int, pz0: int = 0,
                          pz1: int | None = None):
    """Values of the unique corner points with point-z in [pz0, pz1),
    compacted in ascending point-flat-id order, via cumsum + scatter
    (measured faster than searchsorted for the point phase: 105 vs 143 ms).
    The dense per-point value array is a strided slice + transpose of the
    value grid — no index gathers at all. ``psize`` is a static bucket >=
    the true count (multiple of 32768; callers trim on host). Point ids
    are z-major, so a z-range's values are a CONTIGUOUS run of global
    ranks — _sparse_phase_native ships the low-z half first and overlaps
    the host geometry over low-z cells with the high-z transfer.

    Per-cell corner values and case bytes are NOT shipped: the host
    rebuilds both from these point values (bitmap+rank in mc_host.cc;
    np.unique in the numpy fallback), cutting the dominant device→host
    transfer ~4x vs an 8-corner-per-cell stream. Corner colors are not
    gathered either — vertex colors are interpolated on device from the
    resident color grid after welding (see _sparse_phase)."""
    if pz1 is None:
        pz1 = lz + 1
    plane = (ly + 1) * (lx + 1)
    pv_dense = jax.lax.slice(
        values,
        (0, 0, pz0 * step),
        (lx * step + 1, ly * step + 1, (pz1 - 1) * step + 1),
        (step, step, step),
    )  # (lx+1, ly+1, pz1-pz0) value at every point in the z-range
    pv_dense = pv_dense.transpose(2, 1, 0).reshape(-1)  # point-id order
    pm = jax.lax.slice(pmask, (pz0 * plane,), (pz1 * plane,))
    psum = jnp.cumsum(pm.astype(jnp.int32))
    pos = jnp.where(pm, psum - 1, psize)
    out = jnp.zeros((psize + 1,), values.dtype)
    return out.at[pos].set(pv_dense, mode="drop")[:psize]


@jax.jit
def _edge_vertex_colors_from_grid(values_flat, colors_flat, base, vi, off1,
                                  off2, iso):
    """Edge-vertex colors computed ENTIRELY from the device-resident grids:
    endpoint flat ids come from the cell base + per-edge offset LUTs, and
    the inverse-|value| weights (Cell.cs:298-311) are recomputed from the
    value grid in f32 — so the host uploads only (base, vi) per vertex,
    ~2.4x less than shipping i1/i2/w1. The f32 weight differs from the host
    f64 one by <= 1 ulp, i.e. colors drift <= ~1e-7 vs the numpy path."""
    vi = vi.astype(jnp.int32)
    i1 = base + jnp.take(off1, vi)
    i2 = base + jnp.take(off2, vi)
    va = jnp.take(values_flat, i1) - iso
    vb = jnp.take(values_flat, i2) - iso
    eps = jnp.float32(FLT_EPSILON)
    t1 = 1.0 / (eps + jnp.abs(va))
    t2 = 1.0 / (eps + jnp.abs(vb))
    w = (t1 / (t1 + t2))[:, None]
    blend = jnp.take(colors_flat, i1, axis=0) * w + jnp.take(
        colors_flat, i2, axis=0
    ) * (1.0 - w)
    # f16 on the wire: the vertex-color fetch is the largest remaining mesh
    # transfer (V x 12 B) over a ~10-30 MB/s link; halving it costs <= 2^-11
    # relative quantization, identical across every path (numpy, C++,
    # sharded) because they all blend through this kernel. Hosts upcast.
    return blend.astype(jnp.float16)


@jax.jit
def _center_vertex_colors_from_grid(values_flat, colors_flat, base, deltas,
                                    iso):
    """Center-vertex (v12) colors from the device-resident grids: 8-corner
    inverse-|value| weighted blend (Cell.CalculateCenterVertex,
    Cell.cs:501-549) with the strengths recomputed on device in f32."""
    ids = (base[:, None] + deltas[None, :]).reshape(-1)
    n = base.shape[0]
    vv = jnp.take(values_flat, ids).reshape(n, 8) - iso
    s = 1.0 / (jnp.float32(FLT_EPSILON) + jnp.abs(vv))
    w = s / jnp.sum(s, axis=1, keepdims=True)
    c = jnp.take(colors_flat, ids, axis=0).reshape(n, 8, 3)
    # f16 on the wire (see _edge_vertex_colors_from_grid).
    return jnp.sum(c * w[:, :, None], axis=1).astype(jnp.float16)


def _test_face(face, v8):
    """Vectorized MarchingCubes.TestFace (MarchingCubes.cs:376-407).

    face: (m,) int array of signed face ids; v8: (8, m) corner values.
    Returns (m,) bool.
    """
    face = np.asarray(face, np.int64)
    abs_face = np.abs(face)
    corners = luts.FACE_CORNERS[abs_face]  # (m, 4)
    m = np.arange(face.shape[0])
    A = v8[corners[:, 0], m]
    B = v8[corners[:, 1], m]
    C = v8[corners[:, 2], m]
    D = v8[corners[:, 3], m]
    ac_bd = A * C - B * D
    near_zero = (ac_bd > -FLT_EPSILON) & (ac_bd < FLT_EPSILON)
    return np.where(near_zero, face >= 0, face * A * ac_bd >= 0)


def _test_internal(cas, s, v8, edge=None):
    """Vectorized MarchingCubes.TestInternal (MarchingCubes.cs:412-546).

    cas: python int (4, 6, 7, 10, 12 or 13); s: (m,) signed test values;
    edge: (m,) reference edge for cases 6/7/12/13. Returns (m,) bool.
    """
    s = np.asarray(s, np.float64)
    m = s.shape[0]
    idx = np.arange(m)

    if cas in (4, 10):
        a = (v8[4] - v8[0]) * (v8[6] - v8[2]) - (v8[7] - v8[3]) * (v8[5] - v8[1])
        b = (
            v8[2] * (v8[4] - v8[0])
            + v8[0] * (v8[6] - v8[2])
            - v8[1] * (v8[7] - v8[3])
            - v8[3] * (v8[5] - v8[1])
        )
        t = -b / (2.0 * a + FLT_EPSILON)
        early = (t < 0) | (t > 1)
        At = v8[0] + (v8[4] - v8[0]) * t
        Bt = v8[3] + (v8[7] - v8[3]) * t
        Ct = v8[2] + (v8[6] - v8[2]) * t
        Dt = v8[1] + (v8[5] - v8[1]) * t
    else:
        edge = np.asarray(edge, np.int64)
        t0 = luts.INT_T[edge, 0]
        t1 = luts.INT_T[edge, 1]
        va = v8[t0, idx]
        vb = v8[t1, idx]
        t = va / (va - vb + FLT_EPSILON)
        early = np.zeros(m, bool)
        At = np.zeros(m)

        def interp(tab):
            x0 = v8[tab[edge, 0], idx]
            x1 = v8[tab[edge, 1], idx]
            return x0 + (x1 - x0) * t

        Bt = interp(luts.INT_B)
        Ct = interp(luts.INT_C)
        Dt = interp(luts.INT_D)

    test = (
        (At >= 0).astype(np.int64)
        + 2 * (Bt >= 0).astype(np.int64)
        + 4 * (Ct >= 0).astype(np.int64)
        + 8 * (Dt >= 0).astype(np.int64)
    )
    # Outcome per test nibble (MarchingCubes.cs:526-545): True means "s>0
    # wins". tests {0..4,6,8,9,12} -> s>0; {7,11,13,14,15} -> s<0; 5 and 10
    # depend on the saddle product sign.
    saddle = At * Ct - Bt * Dt
    pos = np.isin(test, (0, 1, 2, 3, 4, 6, 8, 9, 12))
    pos |= (test == 5) & (saddle < FLT_EPSILON)
    pos |= (test == 10) & (saddle >= FLT_EPSILON)
    result = np.where(pos, s > 0, s < 0)
    return np.where(early, s > 0, result)


def _dispatch(casenum, config, v8):
    """Vectorized TheBigSwitch (MarchingCubes.cs:94-371).

    casenum, config: (m,) int arrays for active cells; v8: (8, m) float64.
    Returns a list of (cell_indices, vi_rows) where vi_rows is
    (len(cell_indices), 3*nt) of edge indices 0..12.
    """
    groups = []

    def emit(sel, lut, cfg, nt, sub=None):
        if sel.size == 0:
            return
        if sub is None:
            rows = lut[cfg, : 3 * nt]
        else:
            rows = lut[cfg, sub, : 3 * nt]
        groups.append((sel, rows))

    def faces_of(sel, face_ids):
        return _test_face(face_ids, v8[:, sel])

    for cas in range(1, 15):
        mask = casenum == cas
        if not mask.any():
            continue
        sel = np.nonzero(mask)[0]
        cfg = config[sel]

        if cas == 1:
            emit(sel, luts.tiling1, cfg, 1)
        elif cas == 2:
            emit(sel, luts.tiling2, cfg, 2)
        elif cas == 3:
            t = faces_of(sel, luts.test3[cfg])
            emit(sel[t], luts.tiling3_2, cfg[t], 4)
            emit(sel[~t], luts.tiling3_1, cfg[~t], 2)
        elif cas == 4:
            t = _test_internal(4, luts.test4[cfg], v8[:, sel])
            emit(sel[t], luts.tiling4_1, cfg[t], 2)
            emit(sel[~t], luts.tiling4_2, cfg[~t], 6)
        elif cas == 5:
            emit(sel, luts.tiling5, cfg, 3)
        elif cas == 6:
            f = faces_of(sel, luts.test6[cfg, 0])
            emit(sel[f], luts.tiling6_2, cfg[f], 5)
            s2, c2 = sel[~f], cfg[~f]
            ti = _test_internal(
                6, luts.test6[c2, 1], v8[:, s2], edge=luts.test6[c2, 2]
            )
            emit(s2[ti], luts.tiling6_1_1, c2[ti], 3)
            emit(s2[~ti], luts.tiling6_1_2, c2[~ti], 9)
        elif cas == 7:
            sub = (
                faces_of(sel, luts.test7[cfg, 0]).astype(np.int64)
                + 2 * faces_of(sel, luts.test7[cfg, 1]).astype(np.int64)
                + 4 * faces_of(sel, luts.test7[cfg, 2]).astype(np.int64)
            )
            m0 = sub == 0
            emit(sel[m0], luts.tiling7_1, cfg[m0], 3)
            for sc, k in ((1, 0), (2, 1), (4, 2)):
                mk = sub == sc
                emit(sel[mk], luts.tiling7_2, cfg[mk], 5, sub=k)
            for sc, k in ((3, 0), (5, 1), (6, 2)):
                mk = sub == sc
                emit(sel[mk], luts.tiling7_3, cfg[mk], 9, sub=k)
            m7 = sub == 7
            s7, c7 = sel[m7], cfg[m7]
            ti = _test_internal(
                7, luts.test7[c7, 3], v8[:, s7], edge=luts.test7[c7, 4]
            )
            emit(s7[ti], luts.tiling7_4_2, c7[ti], 9)
            emit(s7[~ti], luts.tiling7_4_1, c7[~ti], 5)
        elif cas == 8:
            emit(sel, luts.tiling8, cfg, 2)
        elif cas == 9:
            emit(sel, luts.tiling9, cfg, 4)
        elif cas in (10, 12):
            test_t = luts.test10 if cas == 10 else luts.test12
            t11_ = luts.tiling10_1_1_ if cas == 10 else luts.tiling12_1_1_
            t2 = luts.tiling10_2 if cas == 10 else luts.tiling12_2
            t2_ = luts.tiling10_2_ if cas == 10 else luts.tiling12_2_
            t11 = luts.tiling10_1_1 if cas == 10 else luts.tiling12_1_1
            t12 = luts.tiling10_1_2 if cas == 10 else luts.tiling12_1_2
            f0 = faces_of(sel, test_t[cfg, 0])
            f1 = faces_of(sel, test_t[cfg, 1])
            m_a = f0 & f1
            m_b = f0 & ~f1
            m_c = ~f0 & f1
            m_d = ~f0 & ~f1
            emit(sel[m_a], t11_, cfg[m_a], 4)
            emit(sel[m_b], t2, cfg[m_b], 8)
            emit(sel[m_c], t2_, cfg[m_c], 8)
            sd, cd = sel[m_d], cfg[m_d]
            if cas == 10:
                ti = _test_internal(10, test_t[cd, 2], v8[:, sd])
            else:
                ti = _test_internal(
                    12, test_t[cd, 2], v8[:, sd], edge=test_t[cd, 3]
                )
            emit(sd[ti], t11, cd[ti], 4)
            emit(sd[~ti], t12, cd[~ti], 8)
        elif cas == 11:
            emit(sel, luts.tiling11, cfg, 4)
        elif cas == 13:
            bits = np.zeros(sel.shape[0], np.int64)
            for b in range(6):
                bits += (1 << b) * faces_of(sel, luts.test13[cfg, b]).astype(
                    np.int64
                )
            sub = luts.subconfig13[bits].astype(np.int64)
            m0 = sub == 0
            emit(sel[m0], luts.tiling13_1, cfg[m0], 4)
            for sc in range(1, 7):
                mk = sub == sc
                emit(sel[mk], luts.tiling13_2, cfg[mk], 6, sub=sc - 1)
            for sc in range(7, 19):
                mk = sub == sc
                emit(sel[mk], luts.tiling13_3, cfg[mk], 10, sub=sc - 7)
            for sc in range(19, 23):
                mk = sub == sc
                emit(sel[mk], luts.tiling13_4, cfg[mk], 12, sub=sc - 19)
            for sc in range(23, 27):
                mk = sub == sc
                sk, ck = sel[mk], cfg[mk]
                s2 = sc - 23
                edge = luts.tiling13_5_1[ck, s2, 0]
                ti = _test_internal(13, luts.test13[ck, 6], v8[:, sk], edge=edge)
                emit(
                    sk[ti],
                    luts.tiling13_5_1,
                    ck[ti],
                    6,
                    sub=np.full(ti.sum(), s2),
                )
                emit(
                    sk[~ti],
                    luts.tiling13_5_2,
                    ck[~ti],
                    10,
                    sub=np.full((~ti).sum(), s2),
                )
            for sc in range(27, 39):
                mk = sub == sc
                emit(sel[mk], luts.tiling13_3_, cfg[mk], 10, sub=sc - 27)
            for sc in range(39, 45):
                mk = sub == sc
                emit(sel[mk], luts.tiling13_2_, cfg[mk], 6, sub=sc - 39)
            m45 = sub == 45
            emit(sel[m45], luts.tiling13_1_, cfg[m45], 4)
        elif cas == 14:
            emit(sel, luts.tiling14, cfg, 4)

    return groups


def _corner_gradients(v8):
    """Per-cell corner gradients vg (Cell.PrepareForAddingTriangles,
    Cell.cs:486-498), MC corner numbering, shape (8, m, 3) float32 —
    corner-major with contiguous xyz so the per-stream gather in the normal
    pass is one cache-friendly fancy index. Differences are taken in f32 —
    identical to rounding the f64 difference for corner values that are
    themselves exact f32 sums, and half the memory traffic."""
    v0, v1, v2, v3, v4, v5, v6, v7 = v8.astype(np.float32)
    gx = np.stack([v0 - v1, v0 - v1, v3 - v2, v3 - v2, v4 - v5, v4 - v5,
                   v7 - v6, v7 - v6])
    gy = np.stack([v0 - v3, v1 - v2, v1 - v2, v0 - v3, v4 - v7, v5 - v6,
                   v5 - v6, v4 - v7])
    gz = np.stack([v0 - v4, v1 - v5, v2 - v6, v3 - v7, v0 - v4, v1 - v5,
                   v2 - v6, v3 - v7])
    return np.stack([gx, gy, gz], axis=2)  # (8, m, 3) f32


# Wall-clock of the last create_mesh call, split by phase (ms). Published by
# bench.py; the reference has no equivalent (its meshing is one sequential
# loop, MarchingCubes.cs:53-80).
LAST_TIMINGS: dict = {}


def create_mesh(voxels, iso_value: float = 0.0, step: int = 1, progress=None):
    """Extract the iso-surface mesh (MarchingCubes.CreateMesh,
    MarchingCubes.cs:39-92)."""
    import time as _time

    # iso quantized to f32 so the device classification predicate
    # (f32 compare) and the host sparse phase (f64 subtraction of two exact
    # f32 values) see identical signs.
    iso = float(np.float32(iso_value))
    values_dev = jnp.asarray(voxels.values, jnp.float32)
    colors_dev = jnp.asarray(voxels.colors, jnp.float32)
    nx, ny, nz = values_dev.shape
    step = int(step)

    # Visited cell coordinates are the multiples of step strictly below
    # n - step (emulating the reference's `z = -step; while (z < n - 2*step)
    # { z += step; ... }` loops, MarchingCubes.cs:53-66).
    xs = np.arange(0, nx - step, step)
    ys = np.arange(0, ny - step, step)
    zs = np.arange(0, nz - step, step)
    nz_bound = max(nz - 2 * step, 1)

    if progress is not None:
        progress(0.0)

    if xs.size == 0 or ys.size == 0 or zs.size == 0:
        mesh = Mesh(
            np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0)
        )
        if progress is not None:
            progress(1.0)
        return mesh

    # --- dense phase ON DEVICE, one z-slab classify at a time (all device-
    #     resident, no per-slab syncs), then ONE compaction over the whole
    #     volume. Only O(surface) bytes cross to the host: the active-cell
    #     indices and the UNIQUE corner-point values (~4x fewer bytes than
    #     an 8-corner-per-cell stream). Progress fires per slab
    #     during the sweep (the reference reports once per z layer inside
    #     its loop, MarchingCubes.cs:81). ---
    t0 = _time.perf_counter()
    lx, ly, lz = xs.size, ys.size, zs.size
    slab = max(1, -(-lz // N_PROGRESS_SLABS))
    iso32 = jnp.float32(iso)
    mask_parts = []
    for s0 in range(0, lz, slab):
        m = min(slab, lz - s0)
        _, mask = _classify_slab(
            values_dev, iso32, s0 * step, step, lx, ly, m
        )
        mask_parts.append(mask)
        if progress is not None:
            for z in zs[s0 : s0 + m]:
                progress(float(z) / nz_bound)
    mask_all = jnp.concatenate(mask_parts) if len(mask_parts) > 1 else mask_parts[0]
    pmask = _point_mask(mask_all, lx, ly, lz)
    cellbits = _pack_bits(mask_all)
    # Point-grid z-splits for the pipelined point-value transfer: chunks
    # ship low-z first and the host geometry over already-covered cells
    # overlaps the remaining chunks' time on the link. More chunks on big
    # grids (512^3 ships ~10 MB of point values — nearly all the host work
    # hides under it); small grids keep dispatch overhead low. The 96
    # threshold keeps the 4-chunk path inside the CPU suite's 128^3 golden
    # (tests/test_marching_cubes.py::test_sphere128_progress).
    n_chunks = 8 if lz >= 256 else (4 if lz >= 96 else 2)
    edges = sorted(
        {max(1, round((k + 1) * (lz + 1) / n_chunks))
         for k in range(n_chunks - 1)} | {lz + 1}
    )
    plane = (ly + 1) * (lx + 1)
    counts = np.asarray(
        _counts_split(
            mask_all, pmask, cellbits,
            tuple(e * plane for e in edges[:-1]),
        )
    )  # the ONE sync
    count, pcount, nzw = int(counts[0]), int(counts[1]), int(counts[2])
    prefixes = [int(c) for c in counts[3:]] + [pcount]
    LAST_TIMINGS.clear()
    LAST_TIMINGS["dense_classify_ms"] = (_time.perf_counter() - t0) * 1e3

    if count == 0:
        return Mesh(
            np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0)
        )

    t0 = _time.perf_counter()
    # All transfers start async in pipeline order so the point values
    # stream over the link WHILE the host decodes the two-level bitmap,
    # builds its corner index, and runs the geometry over already-covered
    # z-ranges (mc_host.cc). The dense word stream never crosses the
    # link — only the level-1 bitmap and the compacted nonzero words do
    # (_compact_nonzero_words).
    wbucket = -(-nzw // 8192) * 8192
    l1bits, nzwords = _compact_nonzero_words(cellbits, wbucket)
    l1bits.copy_to_host_async()
    nzwords.copy_to_host_async()
    pv_chunks = []  # (device_array, pcount_k, edge_k)
    prev_edge, prev_prefix = 0, 0
    for edge, prefix in zip(edges, prefixes):
        n_k = prefix - prev_prefix
        arr = _scatter_point_values(
            values_dev, pmask, step, lx, ly, lz,
            -(-max(n_k, 1) // 8192) * 8192, prev_edge, edge,
        )
        arr.copy_to_host_async()
        pv_chunks.append((arr, n_k, edge))
        prev_edge, prev_prefix = edge, prefix
    l1_host = np.asarray(l1bits)
    nzwords_host = np.asarray(nzwords)[:nzw]
    nat = _native()
    if nat is not None:
        wpos = nat.decode_bits(l1_host, nzw)
        active = nat.decode_bits_sparse(wpos, nzwords_host, count)
    else:
        l1bools = np.unpackbits(l1_host.view(np.uint8), bitorder="little")
        wpos = np.flatnonzero(l1bools[: (lx * ly * lz + 31) // 32])
        assert wpos.size == nzw
        words = np.zeros((lx * ly * lz + 31) // 32, np.uint32)
        words[wpos] = nzwords_host
        bools = np.unpackbits(words.view(np.uint8), bitorder="little")
        active = np.flatnonzero(bools[: lx * ly * lz]).astype(np.int64)
        assert active.size == count
    LAST_TIMINGS["gather_fetch_ms"] = (_time.perf_counter() - t0) * 1e3

    if nat is not None and nx * ny * nz < 2**31:
        # Bounds now, while the device queue is short: a tiny fetch issued
        # after the color dispatches would serialize behind them. Cached on
        # the Voxels.
        size_center = voxels.host_bounds()
        mesh = _sparse_phase_native(
            voxels, active, pv_chunks, values_dev, colors_dev, step,
            lx, ly, lz, iso, nat, size_center,
        )
        if mesh is not None:
            return mesh

    # Numpy fallback: rebuild the per-cell corner values and case bytes from
    # the point values, then run the vectorized sparse phase.
    t0 = _time.perf_counter()
    pv = np.concatenate(
        [np.asarray(arr)[:n_k] for arr, n_k, _ in pv_chunks]
    )
    acx = active % lx
    acy = (active // lx) % ly
    acz = active // (lx * ly)
    cp = (
        (acz[None, :] + luts.CORNER_DZ.astype(np.int64)[:, None])
        * (ly + 1)
        + (acy[None, :] + luts.CORNER_DY.astype(np.int64)[:, None])
    ) * (lx + 1) + (acx[None, :] + luts.CORNER_DX.astype(np.int64)[:, None])
    uniq, inv = np.unique(cp.reshape(-1), return_inverse=True)
    if uniq.size != pcount:  # host/device disagree on the corner-point set
        raise AssertionError(
            f"corner-point reconstruction mismatch: host {uniq.size} vs "
            f"device {pcount}"
        )
    v8_raw = pv[inv.reshape(8, -1)]  # f32, MC corner numbering
    iso_f = np.float32(iso)
    case_index = (
        (v8_raw > iso_f).astype(np.int64)
        * (1 << np.arange(8, dtype=np.int64))[:, None]
    ).sum(axis=0)
    LAST_TIMINGS["v8_reconstruct_ms"] = (_time.perf_counter() - t0) * 1e3

    return _sparse_phase(
        voxels, active, case_index, v8_raw, colors_dev, step, lx, ly, iso
    )


def _sparse_phase(voxels, active, case_index, v8, colors, step: int, lx: int,
                  ly: int, iso: float = 0.0) -> Mesh:
    """Host sparse phase: case dispatch, vertex welding, interpolation,
    gradient normals, world transform. ``active`` are flat (z, y, x)-ordered
    visited-cell indices; ``v8`` are f32 corner values in MC corner
    numbering (8, m). Vertex COLORS are interpolated on device straight
    from ``colors``, the resident (nx, ny, nz, 3) grid — only the final
    (n_verts, 3) result crosses the link (as f16), and its fetch overlaps
    the host gradient pass."""
    import time as _time

    nx, ny, nz = np.shape(voxels.values)

    t0 = _time.perf_counter()
    casenum = luts.cases[case_index, 0].astype(np.int64)
    config = luts.cases[case_index, 1].astype(np.int64)

    # Cell grid coordinates from the flat (z, y, x) index.
    acx = (active % lx) * step
    acy = ((active // lx) % ly) * step
    acz = (active // (lx * ly)) * step

    # Iso-subtracted in float64 — the only precision the ambiguity tests
    # and interpolation ever see, as in the reference's double-typed Cell
    # (Cell.cs:191-233): f32→f64 is lossless and the f64 subtraction of two
    # f32 values is exact.
    v8 = np.asarray(v8, np.float64) - iso
    LAST_TIMINGS["v8_wait_ms"] = (_time.perf_counter() - t0) * 1e3

    def corner_of(rel_dx, rel_dy, rel_dz):
        """(dx, dy, dz) ∈ {0,1}^3 offset arrays -> MC corner index arrays."""
        packed = rel_dz.astype(np.int64) * 4 + rel_dy * 2 + rel_dx
        return luts.OFFSET_TO_MC[packed].astype(np.int64)

    # --- dispatch: per-cell tilings (TheBigSwitch) ---
    t0 = _time.perf_counter()
    groups = _dispatch(casenum, config, v8)

    # --- assemble the global face stream in reference order ---
    n_active = active.size
    lens = np.zeros(n_active, np.int64)
    for sel, rows in groups:
        lens[sel] = rows.shape[1]
    offsets = np.concatenate([[0], np.cumsum(lens)])
    total = offsets[-1]
    stream_vi = np.zeros(total, np.int64)
    stream_cell = np.zeros(total, np.int64)
    for sel, rows in groups:
        L = rows.shape[1]
        pos = offsets[sel][:, None] + np.arange(L)[None, :]
        stream_vi[pos] = rows
        stream_cell[pos] = sel[:, None]

    # --- vertex welding via canonical edge keys (int32 when the grid allows:
    #     the sort inside np.unique is the weld's hot op) ---
    svi = stream_vi
    kx = acx[stream_cell] + step * luts.KEY_OX[svi]
    ky = acy[stream_cell] + step * luts.KEY_OY[svi]
    kz = acz[stream_cell] + step * luts.KEY_OZ[svi]
    kj = luts.KEY_J[svi].astype(np.int64)
    keys = ((kz.astype(np.int64) * ny + ky) * nx + kx) * 4 + kj

    nat = _native()
    if nat is not None and 4 * nx * ny * nz >= 2**31:
        # Grids too large for int32 keys: the single-pass C++ weld beats
        # numpy's int64 unique chain (bitwise-identical output, pinned in
        # tests/test_native.py). At int32 scale numpy's nearly-sorted-input
        # unique is faster, so it keeps the common case.
        vertex_id, rep = nat.weld(keys)
    else:
        if 4 * nx * ny * nz < 2**31:
            keys = keys.astype(np.int32)
        uniq, first_idx, inv = np.unique(
            keys, return_index=True, return_inverse=True
        )
        order = np.argsort(first_idx, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(order.size)
        vertex_id = rank[inv]  # per stream entry
        rep = first_idx[order]  # representative stream entry per vertex
    LAST_TIMINGS["dispatch_weld_ms"] = (_time.perf_counter() - t0) * 1e3

    # --- vertex positions (host, f64) + on-device color interpolation
    #     (Cell.AddFaceFromEdgeIndex / CalculateCenterVertex) ---
    t0 = _time.perf_counter()
    n_verts = rep.size
    verts = np.zeros((n_verts, 3))
    vcols = np.zeros((n_verts, 3), np.float32)

    r_vi = stream_vi[rep]
    r_cell = stream_cell[rep]
    r_cx, r_cy, r_cz = acx[r_cell], acy[r_cell], acz[r_cell]

    if nx * ny * nz >= 2**31:
        raise NotImplementedError(
            "color interpolation flat ids need int64; grids this large do "
            "not fit device memory anyway"
        )
    values_flat = jnp.asarray(voxels.values, jnp.float32).reshape(-1)
    colors_flat = jnp.asarray(colors, jnp.float32).reshape(-1, 3)
    edge_cols_dev = center_cols_dev = None

    edge_m = r_vi < 12
    if edge_m.any():
        evi = r_vi[edge_m]
        cells = r_cell[edge_m]
        ex, ey, ez = r_cx[edge_m], r_cy[edge_m], r_cz[edge_m]
        rel1x = luts.edgesrelx[evi, 0]
        rel1y = luts.edgesrely[evi, 0]
        rel1z = luts.edgesrelz[evi, 0]
        rel2x = luts.edgesrelx[evi, 1]
        rel2y = luts.edgesrely[evi, 1]
        rel2z = luts.edgesrelz[evi, 1]
        d1x = rel1x.astype(np.float64)
        d1y = rel1y.astype(np.float64)
        d1z = rel1z.astype(np.float64)
        d2x = rel2x.astype(np.float64)
        d2y = rel2y.astype(np.float64)
        d2z = rel2z.astype(np.float64)

        k1 = corner_of(rel1x, rel1y, rel1z)
        k2 = corner_of(rel2x, rel2y, rel2z)
        va = v8[k1, cells]
        vb = v8[k2, cells]
        t1 = 1.0 / (FLT_EPSILON + np.abs(va))
        t2 = 1.0 / (FLT_EPSILON + np.abs(vb))
        ff = t1 + t2
        verts[edge_m, 0] = ex + step * (d1x * t1 + d2x * t2) / ff
        verts[edge_m, 1] = ey + step * (d1y * t1 + d2y * t2) / ff
        verts[edge_m, 2] = ez + step * (d1z * t1 + d2z * t2) / ff

        # Launch the device color blend now (weights recomputed on device
        # from the value grid, f32 — same kernel as the native fast path so
        # every path's colors are bit-identical); fetch after the gradient
        # pass.
        base_e = (ex * ny + ey) * nz + ez
        n_e = int(edge_m.sum())
        nb = -(-n_e // 4096) * 4096  # bucketed shapes bound recompiles
        pad = nb - n_e
        off1 = (
            (luts.edgesrelx[:, 0].astype(np.int64) * ny
             + luts.edgesrely[:, 0]) * nz + luts.edgesrelz[:, 0]
        ) * step
        off2 = (
            (luts.edgesrelx[:, 1].astype(np.int64) * ny
             + luts.edgesrely[:, 1]) * nz + luts.edgesrelz[:, 1]
        ) * step
        edge_cols_dev = _edge_vertex_colors_from_grid(
            values_flat, colors_flat,
            jnp.asarray(np.pad(base_e.astype(np.int32), (0, pad))),
            jnp.asarray(np.pad(evi.astype(np.uint8), (0, pad))),
            jnp.asarray(off1.astype(np.int32)),
            jnp.asarray(off2.astype(np.int32)),
            jnp.float32(iso),
        )
        edge_cols_dev.copy_to_host_async()

    center_m = ~edge_m
    if center_m.any():
        cc = r_cell[center_m]
        vv = v8[:, cc]  # (8, k)
        strength = 1.0 / (FLT_EPSILON + np.abs(vv))
        ff = strength.sum(axis=0)
        fx = (strength * luts.CORNER_DX[:, None]).sum(axis=0)
        fy = (strength * luts.CORNER_DY[:, None]).sum(axis=0)
        fz = (strength * luts.CORNER_DZ[:, None]).sum(axis=0)
        verts[center_m, 0] = r_cx[center_m] + step * fx / ff
        verts[center_m, 1] = r_cy[center_m] + step * fy / ff
        verts[center_m, 2] = r_cz[center_m] + step * fz / ff

        base = (r_cx[center_m] * ny + r_cy[center_m]) * nz + r_cz[center_m]
        deltas = (
            (luts.CORNER_DX.astype(np.int64) * ny + luts.CORNER_DY) * nz
            + luts.CORNER_DZ
        ) * step
        k_c = int(center_m.sum())
        nb = -(-k_c // 1024) * 1024
        pad = nb - k_c
        center_cols_dev = _center_vertex_colors_from_grid(
            values_flat, colors_flat,
            jnp.asarray(np.pad(base.astype(np.int32), (0, pad))),
            jnp.asarray(deltas.astype(np.int32)),
            jnp.float32(iso),
        )
        center_cols_dev.copy_to_host_async()
    LAST_TIMINGS["interp_ms"] = (_time.perf_counter() - t0) * 1e3

    # --- gradient accumulation into normals (every face reference
    #     contributes; reproduces Cell.AddGradient* including the vg
    #     packed-vs-MC indexing quirk at Cell.cs:314-333). f32 throughout —
    #     the reference accumulates into float Vector3 normals too
    #     (Cell.cs:65-69) — and it overlaps the color fetch above. ---
    t0 = _time.perf_counter()
    vg = _corner_gradients(v8)  # (8, n_active, 3) f32, MC numbering
    normals = np.zeros((n_verts, 3), np.float32)

    se_m = svi < 12
    if se_m.any() and nat is not None:
        # Single C++ pass over the stream: per-entry endpoint weights times
        # packed-indexed corner gradients, accumulated straight into the
        # welded vertex rows (sparse_phase.cc grad_edges).
        nat.grad_edges(
            svi[se_m], stream_cell[se_m], vertex_id[se_m], v8, vg, normals,
            FLT_EPSILON,
        )
    elif se_m.any():
        # The contribution of a face reference depends only on its
        # (cell, edge) pair, and so does its weld key — so identical pairs
        # (the same vertex referenced by several triangles of one cell's
        # tiling, Cell.cs:272-359) add the same vector. Compress the stream
        # to unique pairs and scale by multiplicity: typically ~2.5x fewer
        # gathers and flops than walking all 3*n_triangles references.
        evi_all = svi[se_m]
        ecell_all = stream_cell[se_m]
        pairkey = ecell_all * 13 + evi_all
        if 13 * n_active < 2**31:
            pairkey = pairkey.astype(np.int32)
        _, uidx, ucnt = np.unique(
            pairkey, return_index=True, return_counts=True
        )
        evi = evi_all[uidx]
        ecell = ecell_all[uidx]
        uvid = vertex_id[se_m][uidx]
        # packed index = dz*4 + dy*2 + dx (Cell.cs:318-319), used to index
        # vv (remapped) AND vg (MC-numbered) — the quirk is using it for vg.
        p1 = luts.EDGE_P1[evi]
        p2 = luts.EDGE_P2[evi]
        # vv is remapped so vv[packed] = value at that offset: look the
        # endpoint values up by MC corner in the gathered v8.
        va = v8[luts.EDGE_MC1[evi], ecell]
        vb = v8[luts.EDGE_MC2[evi], ecell]
        cnt = ucnt.astype(np.float32)
        t1 = (cnt / (FLT_EPSILON + np.abs(va))).astype(np.float32)
        t2 = (cnt / (FLT_EPSILON + np.abs(vb))).astype(np.float32)
        contrib = vg[p1, ecell] * t1[:, None] + vg[p2, ecell] * t2[:, None]
        np.add.at(normals, uvid, contrib)

    sc_m = ~se_m
    if sc_m.any():
        ccell = stream_cell[sc_m]
        vv = v8[:, ccell]
        strength = (1.0 / (FLT_EPSILON + np.abs(vv))).astype(np.float32)
        contrib = np.einsum("kc,kcd->cd", strength, vg[:, ccell])
        np.add.at(normals, vertex_id[sc_m], contrib)
    LAST_TIMINGS["grad_ms"] = (_time.perf_counter() - t0) * 1e3

    # --- collect the device-interpolated colors ---
    t0 = _time.perf_counter()
    if edge_cols_dev is not None:
        vcols[edge_m] = np.asarray(edge_cols_dev)[: int(edge_m.sum())]
    if center_cols_dev is not None:
        vcols[center_m] = np.asarray(center_cols_dev)[: int(center_m.sum())]
    LAST_TIMINGS["colors_wait_ms"] = (_time.perf_counter() - t0) * 1e3

    fverts, fnormals = _finalize_geometry(verts, normals, voxels, (nx, ny, nz))
    return Mesh(fverts, vcols, fnormals, vertex_id.astype(np.int32))


def _finalize_geometry(verts, normals, voxels, dims, size_center=None):
    """Finalize: negative normalized normals (Cell.cs:97-109), index->world
    transform (MarchingCubes.cs:84-91). ``verts`` are f64 index-space
    positions; ``normals`` the f32 accumulated gradients. Returns
    (f32 world vertices, f32 unit normals). ``size_center`` lets callers
    pre-fetch the (tiny) bounds arrays BEFORE queueing device work — a fetch
    issued while async dispatches are in flight waits behind them."""
    nx, ny, nz = dims
    normals = normals.astype(np.float64)
    norm = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = -normals / np.where(norm > 0, norm, 1.0)

    if size_center is None:
        size_center = voxels.host_bounds()
    size, center = size_center
    n = np.array([nx, ny, nz], np.float64)
    scale = size / (n - 1)
    verts = (verts - (n - 1) / 2.0) * scale + center
    normals = normals / scale
    nn = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = normals / np.where(nn > 0, nn, 1.0)
    return verts.astype(np.float32), normals.astype(np.float32)


def _sparse_phase_native(voxels, active, pv_chunks, values, colors,
                         step: int, lx: int, ly: int, lz: int, iso: float,
                         nat, size_center) -> Mesh | None:
    """Sparse phase via the phased C++ geometry kernels (mc_host.cc):
    the corner bitmap/rank index builds WHILE the point values stream; the
    point values themselves arrive in K z-chunks, and the dispatch/weld/
    interp pass over each already-covered cell range runs while the later
    chunks are still on the link; each range's on-device color blend
    launches as soon as its vertices exist — so blend transfers overlap
    the remaining host work and the last one overlaps the C++ finalize.
    Chunking is bit-identical to one pass (welding state persists in the
    handle). Returns None if the C++ side detects a host/device
    inconsistency (caller falls back to the numpy path)."""
    import time as _time

    nx, ny, nz = np.shape(voxels.values)

    # Phase A (C++ bitmap/rank corner index) runs on the active ids WHILE
    # the point values are still streaming over the link.
    t0 = _time.perf_counter()
    mc = nat.McSparse(active, lx, ly, lz, nx, ny, nz, step, iso)
    try:
        return _sparse_phase_native_inner(
            mc, voxels, pv_chunks, values, colors, step, iso,
            lx, ly, nx, ny, nz, t0, size_center,
        )
    finally:
        # The handle owns copies of the active ids, bitmap, rank and vertex
        # arrays (tens of MB at 256^3): free it on EVERY exit path,
        # including an exception in the pvals fetch below.
        mc.close()


def _sparse_phase_native_inner(mc, voxels, pv_chunks, values, colors,
                               step: int, iso: float, lx, ly, nx, ny, nz,
                               t0, size_center) -> Mesh | None:
    import time as _time

    active = mc._active
    if not mc.ok:  # C++ rejected an out-of-range active id (mc_host.cc)
        return None
    LAST_TIMINGS["native_index_ms"] = (_time.perf_counter() - t0) * 1e3

    plane = (ly + 1) * (lx + 1)
    # A cell with cz <= edge-2 touches only corner points with
    # pz <= edge-1, i.e. global point ranks below the chunk-prefix count —
    # verify the index agrees for EVERY boundary BEFORE running geometry
    # on partial buffers (a host/device disagreement must fail cleanly to
    # the numpy path, never read past them).
    prefix = 0
    for _, n_k, edge in pv_chunks:
        prefix += n_k
        if mc.expected_points_below(edge * plane) != prefix:
            return None

    values_flat = jnp.asarray(values, jnp.float32).reshape(-1)
    colors_flat = jnp.asarray(colors, jnp.float32).reshape(-1, 3)
    iso32 = jnp.float32(iso)
    off1 = (
        (luts.edgesrelx[:, 0].astype(np.int64) * ny
         + luts.edgesrely[:, 0]) * nz + luts.edgesrelz[:, 0]
    ) * step
    off2 = (
        (luts.edgesrelx[:, 1].astype(np.int64) * ny
         + luts.edgesrely[:, 1]) * nz + luts.edgesrelz[:, 1]
    ) * step
    deltas = (
        (luts.CORNER_DX.astype(np.int64) * ny + luts.CORNER_DY) * nz
        + luts.CORNER_DZ
    ) * step

    def launch_blends(ci):
        """Device color blends for one chunk's new vertices; returns
        (edge_dev|None, center_dev|None) with async host copies started."""
        edge_dev = center_dev = None
        n_e = ci["edge_vid"].shape[0]
        if n_e:
            nb = -(-n_e // 4096) * 4096  # bucketed shapes bound recompiles
            pad = nb - n_e
            edge_dev = _edge_vertex_colors_from_grid(
                values_flat, colors_flat,
                jnp.asarray(np.pad(ci["edge_base"], (0, pad))),
                jnp.asarray(np.pad(ci["edge_vi"], (0, pad))),
                jnp.asarray(off1.astype(np.int32)),
                jnp.asarray(off2.astype(np.int32)),
                iso32,
            )
            edge_dev.copy_to_host_async()
        k_c = ci["center_vid"].shape[0]
        if k_c:
            nb = -(-k_c // 1024) * 1024
            pad = nb - k_c
            center_dev = _center_vertex_colors_from_grid(
                values_flat, colors_flat,
                jnp.asarray(np.pad(ci["center_base"], (0, pad))),
                jnp.asarray(deltas.astype(np.int32)),
                iso32,
            )
            center_dev.copy_to_host_async()
        return edge_dev, center_dev

    n_active = active.shape[0]
    chunks = []  # (color_inputs, edge_dev, center_dev)
    LAST_TIMINGS["pvals_wait_ms"] = 0.0
    LAST_TIMINGS["native_geometry_ms"] = 0.0
    LAST_TIMINGS["color_dispatch_ms"] = 0.0

    # Pipeline: wait for each point-value chunk, then run geometry over the
    # cell range it completes (plus its color-blend dispatch) WHILE the
    # later chunks are still streaming over the link.
    done_cells = 0
    e_prev = c_prev = 0
    total = 0
    for k, (arr, n_k, edge) in enumerate(pv_chunks):
        t0 = _time.perf_counter()
        total = mc.pvals_chunk(np.asarray(arr)[:n_k])  # blocks on the copy
        LAST_TIMINGS["pvals_wait_ms"] += (_time.perf_counter() - t0) * 1e3

        last = k + 1 == len(pv_chunks)
        if last:
            if total != mc.expected_points():  # device/host disagree
                return None
            n_to = n_active
        else:
            # Cells fully covered by points below this chunk's edge.
            n_to = int(np.searchsorted(active, (edge - 1) * lx * ly))
        t0 = _time.perf_counter()
        if not mc.geometry(None, done_cells, n_to):
            return None
        LAST_TIMINGS["native_geometry_ms"] += (
            _time.perf_counter() - t0
        ) * 1e3
        done_cells = n_to

        t0 = _time.perf_counter()
        ci = mc.color_inputs_since(e_prev, c_prev)
        e_prev, c_prev = mc.n_edge, mc.n_center
        chunks.append((ci, *launch_blends(ci)))
        LAST_TIMINGS["color_dispatch_ms"] += (
            _time.perf_counter() - t0
        ) * 1e3

    # --- gradient accumulation + finalize in C++ while colors stream ---
    t0 = _time.perf_counter()
    fverts, fnormals, stream = mc.grad_finalize(*size_center)
    LAST_TIMINGS["grad_finalize_ms"] = (_time.perf_counter() - t0) * 1e3

    t0 = _time.perf_counter()
    vcols = np.zeros((mc.n_verts, 3), np.float32)
    for ci, edge_dev, center_dev in chunks:
        if edge_dev is not None:
            vcols[ci["edge_vid"]] = np.asarray(edge_dev)[
                : ci["edge_vid"].shape[0]
            ]
        if center_dev is not None:
            vcols[ci["center_vid"]] = np.asarray(center_dev)[
                : ci["center_vid"].shape[0]
            ]
    LAST_TIMINGS["colors_wait_ms"] = (_time.perf_counter() - t0) * 1e3
    return Mesh(fverts, vcols, fnormals, stream)
