"""Point-cloud registration: nearest-neighbor search + iterative closest point.

Reference: SdfKit/KdTree.cs + SdfKit/IterativeClosestPoint.cs. The reference
uses a recursive kd-tree for NN; pointer-chasing trees don't map to an
accelerator's wide data-parallel units, so the behavior-equivalent spec here is a tiled brute-force distance argmin that
runs as one fused XLA computation on device (SURVEY.md section 2, KdTree row).
The ICP outer loop mirrors the reference exactly: robust correspondence
filtering keyed to GoodCorrespondenceDistance (IterativeClosestPoint.cs:94-114),
Kabsch SVD with determinant-sign fix (169-182), convergence on translation
<=1e-4 and rotation <=1e-5 (17-25, 63-73), max 100 iterations.

Searcher independence, verified on hardware: the host parity loop, the
brute-force scan, and the grid scan produce matching trajectories even on
ill-conditioned SURFACE clouds (50k marching-cubes vertices under a 0.03 rad
rotation: all three land on the same 0.0245 sliding local minimum to 5
decimals — an inherent point-to-point-ICP property the reference shares,
not a searcher artifact; uniform volumetric clouds converge to ~1e-6).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

MAX_ITERATIONS = 100  # IterativeClosestPoint.cs:17
GOOD_CORRESPONDENCE_DISTANCE = 0.01  # IterativeClosestPoint.cs:21
CONVERGED_MAX_TRANSLATION = 1.0e-4  # IterativeClosestPoint.cs:23
CONVERGED_MAX_ROTATION = 1.0e-5  # IterativeClosestPoint.cs:25


@partial(jax.jit, static_argnums=(2,))
def _nn_chunked(points, queries, chunk: int):
    """For each query, the index and distance of the nearest point.

    Scans `points` in chunks with a lax.fori_loop carry so the (Nq, chunk)
    distance tile stays bounded regardless of reference-set size.
    """
    n = points.shape[0]
    nchunks = (n + chunk - 1) // chunk
    padded = jnp.pad(points, ((0, nchunks * chunk - n), (0, 0)))

    q2 = jnp.sum(queries * queries, axis=1)  # (Nq,)

    def body(i, carry):
        best_d2, best_i = carry
        block = jax.lax.dynamic_slice(padded, (i * chunk, 0), (chunk, 3))
        p2 = jnp.sum(block * block, axis=1)  # (chunk,)
        # Matmul at HIGHEST precision — a reduced-precision (TF32 or bf16)
        # product loses the low bits that decide argmin between
        # near-equidistant points.
        cross = jnp.matmul(queries, block.T, precision=jax.lax.Precision.HIGHEST)
        d2 = q2[:, None] - 2.0 * cross + p2[None, :]
        # Mask out zero-padded rows past the real point count.
        col = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 1) + i * chunk
        d2 = jnp.where(col < n, d2, jnp.inf)
        arg = jnp.argmin(d2, axis=1)
        dmin = jnp.take_along_axis(d2, arg[:, None], axis=1)[:, 0]
        better = dmin < best_d2
        return (
            jnp.where(better, dmin, best_d2),
            jnp.where(better, arg + i * chunk, best_i),
        )

    init = (
        jnp.full(queries.shape[0], jnp.inf, queries.dtype),
        jnp.zeros(queries.shape[0], jnp.int32),
    )
    best_d2, best_i = jax.lax.fori_loop(0, nchunks, body, init)
    # The q^2 - 2qp + p^2 expansion is a matmul but loses precision to
    # cancellation at large coordinate magnitudes; recompute the winner's
    # distance exactly via the direct difference (the reference's
    # Vector3.Distance is difference-first, KdTree.cs:172).
    diff = queries - padded[best_i]
    return best_i, jnp.sqrt(jnp.sum(diff * diff, axis=1))


def nearest_neighbors(points, queries, chunk: int = 2048):
    """Nearest neighbor of each query among `points`.

    Returns (indices, distances). Equivalent surface to
    ``KdTree.Search(q, out dist)`` (KdTree.cs:160-197).
    """
    points = jnp.asarray(points, jnp.float32)
    queries = jnp.asarray(queries, jnp.float32)
    chunk = int(min(chunk, max(points.shape[0], 1)))
    return _nn_chunked(points, queries, chunk)


# ---------------------------------------------------------------------------
# Grid-bucket NN: the sub-quadratic large-cloud index (the asymptotic
# counterpart of the reference's kd-tree, KdTree.cs:56-197 — O(M log N)
# search). Pointer-chasing trees don't map to an accelerator, and this
# formulation avoids per-query GATHERS of neighbor buckets too: points are
# bucketed once into flat-shift arrays (cells-MINOR (K, 3, P+2M) layout over
# the padded flat cell space; see _grid_query), so a query cell's 27
# neighbor buckets are 27 contiguous flat SHIFTS of that array — no gathers
# at all; queries are sorted by cell per call and scattered into a matching
# (Kq, P) slot grid, and all distance work is dense elementwise math.
# (Whether a plain bucket gather is as fast on a GPU is not measured
# yet.)
#
# Exactness is guaranteed, not assumed: a query is re-answered by the
# brute-force kernel when (a) its best distance could be beaten by a point
# outside its 3x3x3 block (best > distance to the block boundary), (b) the
# runner-up candidate is within the near-tie epsilon of the winner — on
# near-ties the brute path's matmul q^2-2qp+p^2 expansion loses ~2e-6 to
# cancellation and can rank the pair differently than the grid's
# direct-difference d^2, so the tie is resolved by the brute kernel itself
# (answers then match it bit-for-bit, including its rounding) — or (c) its
# cell received more than Kq queries (slot overflow). Exact ties break to
# the lowest original index in both paths (bucket order is
# original-index-ascending, so the masked index-min below inherits it).
# ---------------------------------------------------------------------------

GRID_NN_MIN_POINTS = 50_000  # brute force keeps small clouds (matmul-fast)


@partial(jax.jit, static_argnums=(4, 5))
def _grid_query(p_grid, p_orig, lo, cell, G: int, Kq: int, queries):
    """Dense grid NN pass (see the module comment). ``p_grid``/``p_orig``
    are GridNN's flat-shift bucket arrays: shape (K, 3, P + 2*M) /
    (K, P + 2*M), where P = (G+2)^3 is the PADDED flat cell space (minor
    dim — so every elementwise/reduce op runs over long contiguous rows;
    a cells-major layout would put K~17 in the minor dim) and M = (G+2)^2 + (G+2) + 1 is the shift margin:
    the bucket of a cell's neighbor at offset (dx, dy, dz) is the SAME
    flat array shifted by dx*(G+2)^2 + dy*(G+2) + dz, so each of the 27
    neighbor visits is one contiguous dynamic_slice — no gathers, no
    relayouts. Real data lives at [M, M+P); the pad ring holds sentinel
    points and receives no queries, so shift garbage is masked out.

    Returns (orig_idx, guaranteed) in the caller's query order:
    ``guaranteed`` marks queries whose answer is provably the exact NN AND
    not a near-tie (those go to the brute repair pass so the grid matches
    the brute kernel's own rounding; see GridNN.query)."""
    n_q = queries.shape[0]
    K = p_grid.shape[0]
    gp = G + 2
    P = gp * gp * gp
    M = gp * gp + gp + 1
    n_sentinel = jnp.int32(2**31 - 1)  # > any real original index
    q = queries
    qc = jnp.clip(
        jnp.floor((q - lo[None, :]) / cell[None, :]).astype(jnp.int32),
        0, G - 1,
    )
    # Padded flat cell id (+1 per axis: the pad ring).
    qflat = ((qc[:, 0] + 1) * gp + (qc[:, 1] + 1)) * gp + (qc[:, 2] + 1)

    # Sort queries by cell and compute each one's slot within its cell run.
    iota = jnp.arange(n_q, dtype=jnp.int32)
    sk, perm = jax.lax.sort((qflat, iota), num_keys=1)
    qs = q[perm]
    first = jnp.concatenate([jnp.ones(1, bool), sk[1:] != sk[:-1]])
    run_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(first, iota, 0)
    )
    pos = iota - run_start
    ok_slot = pos < Kq  # overflow slots fall back to brute repair
    safe_pos = jnp.where(ok_slot, pos, 0)
    # Dense query arrays, cells-minor: (Kq, 3, P) coords + (Kq, P) valid.
    coord3 = jnp.arange(3, dtype=jnp.int32)
    q_to = jnp.where(
        ok_slot[:, None], (safe_pos[:, None] * 3 + coord3[None, :]) * P + sk[:, None],
        Kq * 3 * P,
    )
    qg = jnp.zeros((Kq * 3 * P,), jnp.float32)
    qg = qg.at[q_to.reshape(-1)].set(qs.reshape(-1), mode="drop")
    qg = qg.reshape(Kq, 3, P)
    qv = jnp.zeros((Kq * P,), bool)
    qv = qv.at[
        jnp.where(ok_slot, safe_pos * P + sk, Kq * P)
    ].set(True, mode="drop").reshape(Kq, P)

    shifts = jnp.asarray(
        [dx * gp * gp + dy * gp + dz
         for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
        jnp.int32,
    )
    kr = jnp.arange(K, dtype=jnp.int32)

    def block(j, carry):
        best, best2, borig = carry
        off = M + shifts[j]
        pblk = jax.lax.dynamic_slice(p_grid, (0, 0, off), (K, 3, P))
        oblk = jax.lax.dynamic_slice(p_orig, (0, off), (K, P))
        d2 = jnp.sum(
            (qg[:, None, :, :] - pblk[None, :, :, :]) ** 2, axis=2
        )  # (Kq, K, P)
        d2 = jnp.where(
            oblk[None, :, :] < n_sentinel, d2, jnp.inf
        )  # empty point slots
        bd = jnp.min(d2, axis=1)  # (Kq, P)
        bo = jnp.min(
            jnp.where(d2 <= bd[:, None, :], oblk[None, :, :], n_sentinel),
            axis=1,
        )
        # Runner-up: exclude ONE argmin position (exact duplicates of bd
        # keep a second copy, so bd2 == bd there and the near-tie check
        # routes the query to brute repair, as it must).
        am = jnp.argmin(d2, axis=1)  # (Kq, P)
        d2x = jnp.where(
            kr[None, :, None] == am[:, None, :], jnp.inf, d2
        )
        bd2 = jnp.min(d2x, axis=1)
        tie = bd == best
        better = bd < best
        new_borig = jnp.where(
            better, bo, jnp.where(tie, jnp.minimum(bo, borig), borig)
        )
        # Merged top-2 over all blocks so far: the runner-up is the smaller
        # of (loser of the two winners, both previous runner-ups).
        new_best2 = jnp.minimum(
            jnp.maximum(best, bd), jnp.minimum(best2, bd2)
        )
        return jnp.minimum(best, bd), new_best2, new_borig

    shape = (Kq, P)
    best, best2, borig = jax.lax.fori_loop(
        0, 27, block,
        (
            jnp.full(shape, jnp.inf, jnp.float32),
            jnp.full(shape, jnp.inf, jnp.float32),
            jnp.full(shape, n_sentinel, jnp.int32),
        ),
    )

    # Safe radius per dense slot: the nearest possible point OUTSIDE the
    # 3x3x3 block is at least this far (per axis: distance to the block
    # face, infinite where the block is clipped by the data bounding box —
    # no points beyond it). Cell coords recovered from the padded flat id.
    pf = jnp.arange(P, dtype=jnp.int32)
    gc = jnp.stack(
        [pf // (gp * gp) - 1, (pf // gp) % gp - 1, pf % gp - 1]
    )  # (3, P), pad ring at -1 / G
    low_face = lo[:, None] + (gc.astype(jnp.float32) - 1.0) * cell[:, None]
    high_face = lo[:, None] + (gc.astype(jnp.float32) + 2.0) * cell[:, None]
    r_low = jnp.where(
        (gc - 1 >= 0)[None, :, :], qg - low_face[None, :, :], jnp.inf
    )
    r_high = jnp.where(
        (gc + 2 <= G)[None, :, :], high_face[None, :, :] - qg, jnp.inf
    )
    r_safe = jnp.min(jnp.minimum(r_low, r_high), axis=1)  # (Kq, P)

    in_block = jnp.sqrt(best) < r_safe  # boundary ties go to brute force
    # Near-tie between winner and runner-up: the brute kernel's matmul
    # expansion can rank the pair differently (its d^2 carries ~8 ulp of
    # cancellation error relative to the coordinate magnitudes), so send
    # those to the brute repair pass and let IT resolve the tie. The bound
    # is scale-aware via |q|^2 (the dominant magnitude in q^2 - 2qp + p^2).
    tie_eps = 1e-5 * (1.0 + jnp.sum(qg * qg, axis=1))
    guaranteed = in_block & ((best2 - best) > tie_eps) & qv

    # Map dense slots back to the caller's query order.
    slot = safe_pos * P + sk
    res_i = borig.reshape(-1)[slot]
    res_g = guaranteed.reshape(-1)[slot] & ok_slot
    inv = jnp.zeros(n_q, jnp.int32).at[perm].set(iota)
    return res_i[inv], res_g[inv]


class GridNN:
    """Uniform-grid NN index over a fixed point set (see module comment).

    ``target_per_cell`` tunes the grid resolution; if the densest cell would
    exceed ``max_bucket`` candidates (degenerate clustering) or the padded
    dense bucket array would exceed ``max_dense_bytes`` (K far above the
    target blows up the O(G^3 K) layout), the index declines (``ok`` False)
    and callers use brute force."""

    def __init__(self, points, target_per_cell: int = 6,
                 max_bucket: int = 128,
                 max_dense_bytes: int = 512 * 1024 * 1024):
        pts = np.asarray(points, np.float32).reshape(-1, 3)
        self.points = pts
        n = len(pts)
        lo = pts.min(axis=0)
        hi = pts.max(axis=0)
        G = max(int(np.ceil((n / target_per_cell) ** (1.0 / 3.0))), 1)
        ext = np.maximum(hi - lo, 1e-6).astype(np.float32)
        cell = ext / G
        ci = np.clip(
            np.floor((pts - lo) / cell).astype(np.int64), 0, G - 1
        )
        flat = (ci[:, 0] * G + ci[:, 1]) * G + ci[:, 2]
        order = np.argsort(flat, kind="stable").astype(np.int32)
        flat_sorted = flat[order]
        counts = np.bincount(flat_sorted, minlength=G * G * G).astype(
            np.int32
        )
        K = int(counts.max()) if n else 0
        gp = G + 2
        # Decline when the dense layouts would blow up: the bucket arrays
        # are O((G+2)^3 K) and the per-query distance tensor is
        # O((G+2)^3 K Kq) (the flat-shift layout computes over the PADDED
        # cell space) — both explode when clustering pushes K far past
        # target_per_cell (that degenerate regime is exactly what
        # max_bucket exists for; callers fall back to the brute matmul
        # kernel).
        self.ok = (
            0 < K <= max_bucket
            and gp * gp * gp * K * 16 <= max_dense_bytes
            and gp * gp * gp * K * (K + 8) * 4 <= max_dense_bytes
        )
        if not self.ok:
            return
        starts = np.concatenate(
            [[0], np.cumsum(counts)[:-1]]
        ).astype(np.int64)
        # Flat-shift bucket arrays (see _grid_query): cells-minor
        # (K, 3, P + 2M) layout with an M-element shift margin on both
        # ends, real data at [M, M + P). Bucket order is original-index-
        # ascending (stable sort), which the masked index-min in
        # _grid_query relies on for tie-breaking.
        p_flat = gp * gp * gp
        margin = gp * gp + gp + 1
        rank_in_bucket = np.arange(n, dtype=np.int64) - starts[flat_sorted]
        cs = ci[order] + 1  # +1: pad ring
        cell_id = (cs[:, 0] * gp + cs[:, 1]) * gp + cs[:, 2]
        ext = p_flat + 2 * margin
        p_grid = np.zeros((K, 3, ext), np.float32)
        p_orig = np.full((K, ext), 2**31 - 1, np.int32)
        p_grid[rank_in_bucket, :, margin + cell_id] = pts[order]
        p_orig[rank_in_bucket, margin + cell_id] = order
        self.G, self.K = G, K
        self.Kq = K + 8  # query slots per cell before overflow->repair
        self._dev = (
            jnp.asarray(p_grid),
            jnp.asarray(p_orig),
            jnp.asarray(lo),
            jnp.asarray(cell),
        )

    def query(self, queries):
        """Exact NN: dense grid pass + brute-force repair of unguaranteed
        queries (out-of-block candidates possible, winner/runner-up within
        the near-tie epsilon, or query-slot overflow — see the module
        comment). Returns (orig_indices, distances) — identical to the
        brute-force kernel's answers, including its lowest-index
        tie-breaking and its own rounding on near-ties, because near-ties
        are answered BY it."""
        q = jnp.asarray(queries, jnp.float32).reshape(-1, 3)
        p_grid, p_orig, lo, cell = self._dev
        idx, guaranteed = _grid_query(
            p_grid, p_orig, lo, cell, self.G, self.Kq, q
        )
        idx = np.array(idx)  # writable copy (jax buffers are read-only)
        bad = np.flatnonzero(~np.asarray(guaranteed))
        if bad.size:
            bidx, _ = nearest_neighbors(self.points, np.asarray(q)[bad])
            idx[bad] = np.asarray(bidx)
        # Exact distance recompute, same op order as _nn_chunked's tail.
        diff = np.asarray(q) - self.points[idx]
        return idx, np.sqrt(np.sum(diff * diff, axis=1))


class NearestNeighbors:
    """Mutable NN index mirroring the reference KdTree API (add_points /
    search). Backed by the device brute-force kernel for small clouds and
    the exact grid-bucket index (GridNN) past GRID_NN_MIN_POINTS — the
    sub-quadratic regime where the reference's kd-tree would win
    asymptotically. Both give identical answers."""

    def __init__(self, points, grid_min_points: int | None = None):
        self._points = np.asarray(points, np.float32).reshape(-1, 3)
        if len(self._points) == 0:
            raise ValueError("at least one point must be given")
        self._grid = None
        self._grid_min = (
            GRID_NN_MIN_POINTS if grid_min_points is None else grid_min_points
        )

    @property
    def total_points(self) -> int:
        return len(self._points)

    @property
    def points(self) -> np.ndarray:
        return self._points

    def add_points(self, points) -> None:
        points = np.asarray(points, np.float32).reshape(-1, 3)
        self._points = np.concatenate([self._points, points], axis=0)
        self._grid = None  # rebuild lazily against the grown set

    def _searcher(self):
        if len(self._points) >= self._grid_min:
            if self._grid is None:
                self._grid = GridNN(self._points)
            if self._grid.ok:
                return self._grid.query
        return lambda q: nearest_neighbors(self._points, q)

    def search(self, query):
        """Nearest point to `query` (a single (3,) point or (N, 3) batch).
        Returns (nearest_points, distances)."""
        q = np.asarray(query, np.float32)
        single = q.ndim == 1
        idx, dist = self._searcher()(q.reshape(-1, 3))
        pts = self._points[np.asarray(idx)]
        if single:
            return pts[0], float(dist[0])
        return pts, np.asarray(dist)


# Alias for discoverability from the reference's name.
KdTree = NearestNeighbors


def _kabsch(p_centered, q_centered):
    """Rotation 3x3 (row-vector convention matching the reference,
    IterativeClosestPoint.cs:149-182): r = V diag(1,1,det) U^T from the SVD
    of the cross-covariance c = sum_i outer(p_i, q_i)."""
    c = p_centered.T @ q_centered  # c[i,j] = sum p_i q_j
    u, _s, vt = np.linalg.svd(c)
    v = vt.T
    det_sign = np.sign(np.linalg.det(v @ u.T))
    sd = np.diag([1.0, 1.0, det_sign])
    return v @ sd @ u.T


def _transform_points(points, m):
    """Row-vector transform: p' = p @ M[:3,:3] + M[3,:3]."""
    return points @ m[:3, :3] + m[3, :3]


def robust_distance_cutoff(dist_mean: float, dist_std: float,
                           good: float = GOOD_CORRESPONDENCE_DISTANCE) -> float:
    """The reference's 4-branch correspondence-distance cutoff, transliterated
    from IterativeClosestPoint.cs:101-114. Note the fourth branch: the C#
    comment above it quotes the ICP paper's "valley after the maximal peak"
    rule, but the CODE is literally ``distMax = distMean + 0.5f + distStd``
    (line 113) — no histogram is ever built, so exact parity IS this constant
    formula. Pinned branch-for-branch in tests/test_icp.py."""
    if dist_mean < good:
        return dist_mean + 3.0 * dist_std
    if dist_mean < 3.0 * good:
        return dist_mean + 2.0 * dist_std
    if dist_mean < 6.0 * good:
        return dist_mean + dist_std
    return dist_mean + 0.5 + dist_std


class IterativeClosestPoint:
    """Point-to-point ICP against a static point set
    (IterativeClosestPoint.cs:10-205)."""

    def __init__(self, static_points):
        if isinstance(static_points, (list, tuple)):
            if len(static_points) == 0:
                raise ValueError("at least one set of points must be given")
            pts = np.concatenate(
                [np.asarray(p, np.float32).reshape(-1, 3) for p in static_points]
            )
        else:
            pts = np.asarray(static_points, np.float32).reshape(-1, 3)
        self._nn = NearestNeighbors(pts)
        self.max_iterations = MAX_ITERATIONS
        self.good_correspondence_distance = GOOD_CORRESPONDENCE_DISTANCE
        self.converged_maximum_translation = CONVERGED_MAX_TRANSLATION
        self.converged_maximum_rotation = CONVERGED_MAX_ROTATION

    def add_static_points(self, points) -> None:
        self._nn.add_points(points)

    def register_points(self, points, parity: bool | None = None):
        """Rigidly align `points` to the static set.

        Returns (aligned_points, total_transform) where total_transform is the
        4x4 row-vector matrix that maps the input points to their aligned
        locations (the reference mutates in place and returns the transform,
        IterativeClosestPoint.cs:53-75).

        ``parity``: True runs the host numpy loop that mirrors the reference
        step for step (early exit, float64 SVD) but pays one device round
        trip per iteration for the NN search — up to 100 of them. False runs the whole registration as
        ONE jit'd ``lax.scan`` dispatch on device (register_points_jax; same
        per-iteration math, convergence freeze instead of early exit; past
        GRID_NN_MIN_POINTS the exact grid-bucket NN runs inside the scan,
        so large clouds stay one dispatch AND sub-quadratic). The default
        (None) picks the device path, falling back to numpy on CPU (where
        per-dispatch latency is nil and early exit wins) or when the
        instance's thresholds were changed from the reference defaults
        (the jit'd path compiles the defaults in)."""
        non_default_thresholds = (
            self.good_correspondence_distance != GOOD_CORRESPONDENCE_DISTANCE
            or self.converged_maximum_translation != CONVERGED_MAX_TRANSLATION
            or self.converged_maximum_rotation != CONVERGED_MAX_ROTATION
        )
        if parity is None:
            parity = (
                jax.default_backend() == "cpu"
                or self.max_iterations != MAX_ITERATIONS
                or non_default_thresholds
            )
        if not parity and non_default_thresholds:
            # The jit'd path compiles the module-default thresholds in;
            # silently ignoring customized instance values would produce
            # wrong-looking results.
            raise ValueError(
                "parity=False (the jit'd scan path) supports only the "
                "default ICP thresholds; leave parity unset or use "
                "parity=True for customized thresholds"
            )
        if not parity:
            # Reuse (and cache) the instance's grid index: rebuilding it per
            # call costs a host O(N) bucketing pass plus a multi-MB device
            # upload.
            grid = None
            if self._nn.total_points >= self._nn._grid_min:
                if self._nn._grid is None:
                    self._nn._grid = GridNN(self._nn.points)
                grid = self._nn._grid
            aligned, total = register_points_jax(
                self._nn.points, points, self.max_iterations, grid=grid
            )
            return (
                np.asarray(aligned, np.float32),
                np.asarray(total, np.float32),
            )
        pts = np.asarray(points, np.float32).reshape(-1, 3).copy()
        total = np.eye(4, dtype=np.float32)

        for _ in range(self.max_iterations):
            transform = self._iter_transform(pts)
            pts = _transform_points(pts, transform).astype(np.float32)

            drot = (
                abs(1.0 - transform[0, 0])
                + abs(1.0 - transform[1, 1])
                + abs(1.0 - transform[2, 2])
            )
            dtrans = float(np.linalg.norm(transform[3, :3]))
            total = total @ transform
            if (
                dtrans <= self.converged_maximum_translation
                and drot <= self.converged_maximum_rotation
            ):
                break
        return pts, total

    def _iter_transform(self, pts) -> np.ndarray:
        """One ICP iteration (GetIterTransform,
        IterativeClosestPoint.cs:77-205). Returns the 4x4 applied transform."""
        cor, dist = self._nn.search(pts)
        dist = np.asarray(dist, np.float64)
        n = len(pts)

        dist_mean = dist.mean()
        dist_std = float(np.sqrt(((dist - dist_mean) ** 2).mean()))
        dist_max = robust_distance_cutoff(
            dist_mean, dist_std, self.good_correspondence_distance
        )

        keep = dist <= dist_max
        p = np.asarray(pts, np.float64)[keep]
        q = np.asarray(cor, np.float64)[keep]
        pmean = p.mean(axis=0)
        qmean = q.mean(axis=0)

        r = _kabsch(p - pmean, q - qmean)

        r4 = np.eye(4)
        r4[:3, :3] = r
        inv_r4 = np.linalg.inv(r4)
        p_rot_mean = pmean @ inv_r4[:3, :3]
        translation = p_rot_mean - qmean

        t4 = np.eye(4)
        t4[3, :3] = translation
        transform = r4 @ t4
        return np.linalg.inv(transform).astype(np.float32)


def _icp_scan(static_points, points, max_iterations: int, nn_fn):
    """Shared lax.scan ICP loop body (see _register_points_jax). ``nn_fn``
    supplies the per-iteration correspondences: the brute-force matmul kernel,
    or the grid-bucket index with fixed-capacity brute repair — both exact,
    so the loop's trajectory is independent of the searcher.

    The convergence freeze is a ``lax.cond`` around the WHOLE step body, so
    once converged the remaining scan iterations execute neither the NN
    search nor the SVD (only the taken cond branch runs) — the
    device-side analogue of the host loop's early exit, typically cutting
    a 100-length scan to the ~10-40 iterations that actually move."""
    eye4 = jnp.eye(4, dtype=jnp.float32)
    good = jnp.float32(GOOD_CORRESPONDENCE_DISTANCE)

    def step(carry, _):
        return jax.lax.cond(carry[2], lambda c: c, _icp_active_step, carry), None

    def _icp_active_step(carry):
        pts, total, done = carry
        idx, dist = nn_fn(pts)
        cor = static_points[idx]

        dist_mean = dist.mean()
        dist_std = jnp.sqrt(((dist - dist_mean) ** 2).mean())
        dist_max = jnp.where(
            dist_mean < good,
            dist_mean + 3.0 * dist_std,
            jnp.where(
                dist_mean < 3.0 * good,
                dist_mean + 2.0 * dist_std,
                jnp.where(
                    dist_mean < 6.0 * good,
                    dist_mean + dist_std,
                    # Exactly the reference's fourth branch
                    # (IterativeClosestPoint.cs:113) — see the numpy path for
                    # why the "valley after the maximal peak" wording in the
                    # C# is a paper quote, not the computed rule.
                    dist_mean + 0.5 + dist_std,
                ),
            ),
        )
        w = (dist <= dist_max).astype(jnp.float32)
        wsum = jnp.maximum(w.sum(), 1.0)
        pmean = (pts * w[:, None]).sum(0) / wsum
        qmean = (cor * w[:, None]).sum(0) / wsum

        c = (w[:, None] * (pts - pmean)).T @ (cor - qmean)
        u, _s, vt = jnp.linalg.svd(c)
        v = vt.T
        det_sign = jnp.sign(jnp.linalg.det(v @ u.T))
        sd = jnp.diag(jnp.stack([1.0, 1.0, det_sign]))
        r = v @ sd @ u.T

        r4 = eye4.at[:3, :3].set(r)
        inv_r4 = jnp.linalg.inv(r4)
        translation = pmean @ inv_r4[:3, :3] - qmean
        t4 = eye4.at[3, :3].set(translation)
        transform = jnp.linalg.inv(r4 @ t4)

        new_pts = pts @ transform[:3, :3] + transform[3, :3]
        drot = (
            jnp.abs(1.0 - transform[0, 0])
            + jnp.abs(1.0 - transform[1, 1])
            + jnp.abs(1.0 - transform[2, 2])
        )
        dtrans = jnp.linalg.norm(transform[3, :3])
        new_done = done | (
            (dtrans <= CONVERGED_MAX_TRANSLATION)
            & (drot <= CONVERGED_MAX_ROTATION)
        )
        return new_pts, total @ transform, new_done

    init = (points, eye4, jnp.bool_(False))
    with jax.default_matmul_precision("float32"):
        (aligned, total, _), _ = jax.lax.scan(
            step, init, None, length=max_iterations
        )
    return aligned, total


@partial(jax.jit, static_argnums=(2, 3))
def _register_points_jax(static_points, points, max_iterations: int, chunk: int):
    """Fully on-device, differentiable ICP (a capability beyond the
    reference; SURVEY §2 maps ICP to "jnp … trivially
    differentiable"). Same per-iteration math as the numpy path
    (IterativeClosestPoint.cs:77-205): NN correspondences, robust distance
    filter, Kabsch SVD with det fix, inverse-transform application — run
    under ``lax.scan`` with a convergence freeze (once converged every later
    step applies the identity), so the whole loop jits and reverse-mode
    differentiates. Gradients flow through the gathered correspondence
    points and the SVD; the argmin indices and the keep mask are
    (correctly) piecewise-constant.

    All matmuls run at float32 precision: the covariance, transform chain and
    point updates are 3x3/4x4 contractions whose operands differ by ~1e-4
    near convergence, and reduced-precision (bf16 or TF32) products stall
    the iteration at ~1e-2 alignment error (float32 converges to 1e-7)."""
    return _icp_scan(
        static_points, points, max_iterations,
        lambda pts: _nn_chunked(static_points, pts, chunk),
    )


# Per-iteration brute repair capacity of the grid-backed ICP scan. The cond
# below falls back to a full brute-force pass for any iteration whose
# unguaranteed-query count exceeds it (typical counts are tens per 100k once
# the clouds roughly overlap; early badly-misaligned iterations trip the
# fallback, which is exactly when brute force is the right answer anyway).
ICP_GRID_REPAIR_CAP = 4096


@partial(jax.jit, static_argnums=(6, 7, 8, 9))
def _register_points_jax_grid(static_points, p_grid, p_orig, lo, cell,
                              points, max_iterations: int,
                              G: int, Kq: int, chunk: int):
    """The grid-backed one-dispatch ICP scan: the exact
    dense grid NN (_grid_query) runs INSIDE the scan step, so large-cloud
    registration is one device dispatch instead of ~max_iterations host
    round trips (the reference pays its kd-tree search inside the loop too,
    IterativeClosestPoint.cs:88-92 + KdTree.cs:160-197). Exactness matches
    the host GridNN.query path: unguaranteed queries (out-of-block,
    near-tie, or slot overflow — see the grid module comment) are
    re-answered by the brute matmul kernel — up to ICP_GRID_REPAIR_CAP of them
    via a fixed-shape repair gather, beyond that by a full brute pass under
    ``lax.cond`` (only the taken branch executes). Differentiability
    is preserved: indices are piecewise-constant and the repair/cond
    plumbing is integer-only."""
    n_q = points.shape[0]
    cap = min(ICP_GRID_REPAIR_CAP, n_q)

    def nn_fn(pts):
        idx_g, ok = _grid_query(p_grid, p_orig, lo, cell, G, Kq, pts)
        bad = ~ok
        n_bad = bad.sum()

        def repair():
            # Unguaranteed queries first (stable argsort of the guarantee
            # flag), then one fixed-shape brute pass over that slice.
            ridx = jnp.argsort(ok)[:cap]
            bidx, _ = _nn_chunked(static_points, pts[ridx], chunk)
            return idx_g.at[ridx].set(
                jnp.where(bad[ridx], bidx, idx_g[ridx])
            )

        # Three-way by unguaranteed count (nested cond; only the taken
        # branch executes): 0 -> grid answers stand as-is (the
        # common case near convergence — skips the ~8 ms repair sort+scan),
        # <= cap -> fixed-shape repair, beyond -> full brute pass.
        idx = jax.lax.cond(
            n_bad == 0,
            lambda: idx_g,
            lambda: jax.lax.cond(
                n_bad > cap,
                lambda: _nn_chunked(static_points, pts, chunk)[0],
                repair,
            ),
        )
        cor = static_points[idx]
        diff = pts - cor
        # Exact direct-difference distance, same op order as _nn_chunked's
        # tail and GridNN.query.
        return idx, jnp.sqrt(jnp.sum(diff * diff, axis=1))

    return _icp_scan(static_points, points, max_iterations, nn_fn)


def register_points_jax(static_points, points,
                        max_iterations: int = MAX_ITERATIONS,
                        nn: str = "auto", grid: "GridNN | None" = None):
    """Differentiable, jit-compiled ICP. Returns (aligned_points,
    total_transform) as jnp arrays; gradients flow to both point sets (e.g.
    ``jax.grad`` of an alignment loss w.r.t. a scan transform works). The
    numpy :class:`IterativeClosestPoint` remains the reference-parity path.

    ``nn``: 'brute' scans all points per iteration (matmul; quadratic),
    'grid' runs the exact grid-bucket index inside the scan (sub-quadratic;
    requires a non-degenerate grid build), 'auto' picks 'grid' past
    GRID_NN_MIN_POINTS when the build succeeds. All choices produce the
    same correspondences (the grid path brute-repairs every query whose
    answer isn't provably exact), so the trajectory is searcher-independent.

    ``grid``: a pre-built GridNN over ``static_points`` to reuse — the
    build is host O(N) bucketing plus a multi-MB dense bucket-array upload
    over the link, so repeated registrations against one static set should
    not pay it per call (IterativeClosestPoint passes its cached index).
    """
    static_points = jnp.asarray(static_points, jnp.float32).reshape(-1, 3)
    points = jnp.asarray(points, jnp.float32).reshape(-1, 3)
    chunk = int(min(2048, max(static_points.shape[0], 1)))
    if nn not in ("auto", "brute", "grid"):
        raise ValueError(f"unknown nn mode {nn!r}")
    if nn != "brute" and (
        nn == "grid" or static_points.shape[0] >= GRID_NN_MIN_POINTS
    ):
        if grid is None:
            grid = GridNN(np.asarray(static_points))
        if grid.ok:
            return _register_points_jax_grid(
                static_points, *grid._dev, points, int(max_iterations),
                grid.G, grid.Kq, chunk,
            )
        if nn == "grid":
            raise ValueError(
                "grid NN index declined (a bucket exceeds max_bucket — "
                "degenerate clustering — or the dense bucket layout "
                "exceeds max_dense_bytes); use nn='brute' or 'auto'"
            )
    return _register_points_jax(static_points, points, int(max_iterations), chunk)


def global_register_points(scans):
    """Chain-register a list of scans: the first scan is the static base, each
    registered scan is folded into the static set
    (IterativeClosestPoint.GlobalRegisterPoints, IterativeClosestPoint.cs:207-238).

    Returns (aligned_scans, transforms)."""
    scans = [np.asarray(s, np.float32).reshape(-1, 3) for s in scans]
    if len(scans) == 0:
        return [], []
    if len(scans) == 1:
        return [scans[0]], [np.eye(4, dtype=np.float32)]
    icp = IterativeClosestPoint(scans[0])
    aligned = [scans[0]]
    transforms = [np.eye(4, dtype=np.float32)]
    for scan in scans[1:]:
        out, tf = icp.register_points(scan)
        aligned.append(out)
        transforms.append(tf)
        icp.add_static_points(out)
    return aligned, transforms
