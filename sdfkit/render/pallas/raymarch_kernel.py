"""Fused sphere-trace kernels for NVIDIA GPUs (Pallas, Triton route).

The reference's hot loop is RayMarcher.Render (RayMarcher.cs:131-162): 40
march iterations + 6 gradient taps + Lambert shading per ray. The jnp path
(render/raymarch.py) runs each march iteration as its own XLA kernel, which
reads the ray arrays and writes the depth frame back to device memory every
step. Here one program owns a flat block of pixels for the whole pipeline:
it generates its rays from the pixel index, marches, shades and writes RGB
(or depth) once, so the output image is the only full-frame traffic.

The backward is a second kernel. It replays the march of its block, keeps
the per-step depths in a per-program history buffer (written and read back
by the same program, so it mostly stays in L2), then sweeps the march in
reverse with one single-evaluation ``jax.vjp`` per step. Parameter and view
gradients are summed per program into a (programs, n_out) partial array that
XLA reduces afterwards, so the result does not depend on program order.

Scene parameters are one packed float32 vector read with scalar loads and
rebuilt into the SdfExpr pytree inside the kernel (``ScalarArray`` leaves),
so the same compiled kernel serves any parameter values.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from sdfkit.render import raymarch as rm
from sdfkit.utils.v3 import V3, ScalarArray

# Pixels per program and warps per program (read at trace time; bench.py
# --sweep times other values).
BLOCK = 256
NUM_WARPS = 4

# Largest scene (in parameter scalars) the fused kernels take. Every scalar is
# an unrolled load, and the backward keeps a per-pixel accumulator for each,
# so registers spill as scenes grow. Measured on an H100 at 1080p (PERF.md):
# at 63 scalars forward+backward is 7.2 ms against 44.3 ms for XLA; at 126
# it is 103.0 against 103.4 ms; at 1022 the backward did not compile within
# 8 minutes. Larger trees go to the jnp path.
MAX_FUSED_PARAM_SCALARS = 64

# inverse(view @ proj) (16) + camera position (3).
N_VIEW = 19

BACKENDS = ("auto", "fused", "interpret", "jnp")


def param_count(sdf) -> int:
    return sum(int(np.prod(jnp.shape(l))) for l in jax.tree_util.tree_leaves(sdf))


def resolve_backend(backend: str, sdf, platform: str | None = None) -> str:
    """The one renderer-backend rule. Returns 'fused', 'interpret' or 'jnp'.

    'auto' picks the fused kernels on a GPU when the scene has at most
    MAX_FUSED_PARAM_SCALARS parameter scalars, else the jnp path. 'fused'
    compiles the kernels for the GPU and refuses any other platform;
    'interpret' runs the same kernels in the Pallas interpreter (tests)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "jnp":
        return backend
    platform = platform or jax.default_backend()
    fits = param_count(sdf) <= MAX_FUSED_PARAM_SCALARS
    if backend == "auto":
        return "fused" if platform == "gpu" and fits else "jnp"
    if backend == "fused" and platform != "gpu":
        raise ValueError(
            f"backend='fused' compiles for a GPU, not {platform!r}; use "
            f"backend='interpret' to run the kernels in the Pallas interpreter"
        )
    if not fits:
        raise ValueError(
            f"scene has {param_count(sdf)} parameter scalars; the fused "
            f"kernels take at most {MAX_FUSED_PARAM_SCALARS} — use "
            f"backend='jnp' for larger scene trees"
        )
    return backend


# ---------------------------------------------------------------------------
# Per-block math, shared by both kernels (identical to render/raymarch.py).
# ---------------------------------------------------------------------------


def _final_shade(sdf, ro: V3, rd: V3, depth, cfg: rm.RenderConfig):
    """The last march step (the sample whose RGB becomes the diffuse color,
    RayMarcher.cs:142-144) plus normal estimation and Lambert shading.
    ``depth`` is the accumulated depth after n-1 march steps. Returns
    (final depth, shaded rgb V3). Loop-free, so its vjp in the backward
    kernel carries only block-sized residuals."""
    pos = ro + rd * depth
    color, dist = sdf.eval(pos)
    diffuse = V3(
        jnp.broadcast_to(color.x, dist.shape),
        jnp.broadcast_to(color.y, dist.shape),
        jnp.broadcast_to(color.z, dist.shape),
    )
    depth = depth + dist

    bg = depth > cfg.far
    # Sanitized branch input for miss rays — see render/raymarch.py
    # render_rays for why (keeps reverse-mode finite).
    shade_depth = jnp.where(bg, cfg.near, depth)
    surface = ro + rd * shade_depth
    e = rm.GRAD_OFFSET

    def d_at(dx, dy, dz):
        return sdf.distance(V3(surface.x + dx, surface.y + dy, surface.z + dz))

    normal = V3(
        d_at(e, 0.0, 0.0) - d_at(-e, 0.0, 0.0),
        d_at(0.0, e, 0.0) - d_at(0.0, -e, 0.0),
        d_at(0.0, 0.0, e) - d_at(0.0, 0.0, -e),
    ).safe_normalize()
    # Constants stay Python floats: Triton lowers no array literal.
    lx, ly, lz = rm.LIGHT_POSITION
    light = (V3(lx, ly, lz) - surface).safe_normalize()
    lambert = jnp.maximum(normal.dot(light), 0.0)
    lighting = diffuse * lambert + rm.AMBIENT
    return depth, lighting.where(~bg, V3(*rm.SKY_COLOR))


def _step(sdf, ro: V3, rd: V3, depth):
    return depth + sdf.distance(ro + rd * depth)


def _start_depth(ro: V3, cfg):
    return ro.x * 0.0 + (cfg.near - 0.1)


def _rays(view, pix0, cfg: rm.RenderConfig, block: int):
    """Ray origin/direction of this program's pixels from the flat pixel
    index. ``view`` is a sequence of N_VIEW values: inverse(view @ proj)
    row-major, then the camera position. ``pix0`` is the global flat index
    of the first pixel the kernel renders (nonzero for a row band under
    shard_map; traced). Identical math to utils/camera.camera_rays."""
    npix = cfg.width * cfg.height
    idx = pix0 + pl.program_id(0) * block + jax.lax.iota(jnp.int32, block)
    # Padding lanes repeat the last real pixel so their marches stay finite.
    idx = jnp.minimum(idx, npix - 1)
    py = idx // cfg.width
    px = idx - py * cfg.width
    xf = -1.0 + 2.0 * px.astype(jnp.float32) / max(cfg.width - 1, 1)
    yf = 1.0 - 2.0 * py.astype(jnp.float32) / max(cfg.height - 1, 1)
    m = view[:16]
    hx = xf * m[0] + yf * m[4] + m[12]
    hy = xf * m[1] + yf * m[5] + m[13]
    hz = xf * m[2] + yf * m[6] + m[14]
    hw = xf * m[3] + yf * m[7] + m[15]
    pos = V3(hx / hw, hy / hw, hz / hw)
    ro = V3(*(jnp.broadcast_to(c, (block,)) for c in view[16:19]))
    return ro, (pos - ro).normalize()


def _pack_params(sdf):
    """Pytree leaves -> (flat f32 vector, static rebuild info)."""
    leaves, treedef = jax.tree_util.tree_flatten(sdf)
    shapes = tuple(tuple(jnp.shape(l)) for l in leaves)
    flat = [jnp.ravel(jnp.asarray(l, jnp.float32)) for l in leaves]
    # Never empty: a pallas_call operand needs at least one element.
    flat = jnp.concatenate(flat + [jnp.zeros((1,), jnp.float32)])
    return flat, (treedef, shapes)


def _rebuild(meta, values):
    """SdfExpr pytree from a flat sequence of per-scalar values."""
    treedef, shapes = meta
    leaves, pos = [], 0
    for shape in shapes:
        k = int(np.prod(shape))
        if shape == ():
            leaves.append(values[pos])
        else:
            items = np.empty(k, dtype=object)
            for j in range(k):
                items[j] = values[pos + j]
            leaves.append(ScalarArray(items.reshape(shape)))
        pos += k
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _unpack_grads(meta, flat):
    treedef, shapes = meta
    leaves, pos = [], 0
    for shape in shapes:
        k = int(np.prod(shape))
        leaves.append(flat[pos : pos + k].reshape(shape))
        pos += k
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _n_scalars(meta) -> int:
    return sum(int(np.prod(s)) for s in meta[1])


# ---------------------------------------------------------------------------
# Kernels.
# ---------------------------------------------------------------------------


def _forward_kernel(params_ref, view_ref, pix0_ref, *out_refs, meta, cfg,
                    want_color, block):
    sdf = _rebuild(meta, [params_ref[j] for j in range(_n_scalars(meta))])
    view = [view_ref[k] for k in range(N_VIEW)]
    ro, rd = _rays(view, pix0_ref[0], cfg, block)
    depth = jax.lax.fori_loop(
        0, cfg.depth_iterations - 1,
        lambda _, d: _step(sdf, ro, rd, d), _start_depth(ro, cfg),
    )
    if want_color:
        _, rgb = _final_shade(sdf, ro, rd, depth, cfg)
        for ref, c in zip(out_refs, (rgb.x, rgb.y, rgb.z)):
            ref[...] = c
    else:
        out_refs[0][...] = _step(sdf, ro, rd, depth)


def _backward_kernel(params_ref, view_ref, pix0_ref, *refs, meta, cfg,
                     want_color, block):
    *g_refs, part_ref, hist_ref = refs
    pid = pl.program_id(0)
    n = cfg.depth_iterations
    n_params = _n_scalars(meta)
    p_scalars = [params_ref[j] for j in range(n_params)]
    # Differentiate w.r.t. block-shaped copies of every scalar, so each
    # step's pullback accumulates per pixel and one sum per program at the
    # end replaces a block reduction per parameter per step.
    bcast = lambda s: jnp.broadcast_to(s, (block,))
    p_blocks = [bcast(s) for s in p_scalars]
    v_blocks = [bcast(view_ref[k]) for k in range(N_VIEW)]
    pix0 = pix0_ref[0]

    def rays_fn(v):
        ro, rd = _rays(v, pix0, cfg, block)
        return (ro, rd)

    (ro, rd), rays_vjp = jax.vjp(rays_fn, v_blocks)

    # Forward replay; the pre-step depths go to this program's history.
    sdf = _rebuild(meta, p_scalars)

    def fwd_body(i, depth):
        hist_ref[pid, i, :] = depth
        return _step(sdf, ro, rd, depth)

    d_last = jax.lax.fori_loop(0, n - 1, fwd_body, _start_depth(ro, cfg))

    if want_color:
        def final_fn(p, ro, rd, depth):
            _, rgb = _final_shade(_rebuild(meta, p), ro, rd, depth, cfg)
            return rgb.x, rgb.y, rgb.z

        ct = tuple(r[...] for r in g_refs)
    else:
        def final_fn(p, ro, rd, depth):
            return _step(_rebuild(meta, p), ro, rd, depth)

        ct = g_refs[0][...]
    _, fvjp = jax.vjp(final_fn, p_blocks, ro, rd, d_last)
    g_p, g_ro, g_rd, g_depth = fvjp(ct)

    def step_fn(p, ro, rd, depth):
        return _step(_rebuild(meta, p), ro, rd, depth)

    add = lambda a, b: jax.tree_util.tree_map(jnp.add, a, b)

    def bwd_body(k, carry):
        g_depth, g_p, g_ro, g_rd = carry
        d_i = hist_ref[pid, n - 2 - k, :]
        _, svjp = jax.vjp(step_fn, p_blocks, ro, rd, d_i)
        gp, gro, grd, g_depth = svjp(g_depth)
        return g_depth, add(g_p, gp), add(g_ro, gro), add(g_rd, grd)

    _, g_p, g_ro, g_rd = jax.lax.fori_loop(
        0, n - 1, bwd_body, (g_depth, g_p, g_ro, g_rd)
    )
    (g_v,) = rays_vjp((g_ro, g_rd))

    for j, g in enumerate(list(g_p) + list(g_v)):
        part_ref[pid, j] = jnp.sum(g)


def _compiler_params(num_warps: int):
    return pl_triton.CompilerParams(num_warps=num_warps)


@partial(jax.jit, static_argnames=("meta", "cfg", "want_color", "local_npix",
                                   "interpret", "block", "num_warps"))
def _forward(params, view, pix0, *, meta, cfg, want_color, local_npix,
             interpret, block, num_warps):
    programs = -(-local_npix // block)
    n_out = 3 if want_color else 1
    return pl.pallas_call(
        partial(_forward_kernel, meta=meta, cfg=cfg, want_color=want_color,
                block=block),
        grid=(programs,),
        in_specs=[pl.BlockSpec()] * 3,
        out_specs=[pl.BlockSpec((block,), lambda i: (i,))] * n_out,
        out_shape=[jax.ShapeDtypeStruct((programs * block,), jnp.float32)]
        * n_out,
        backend="triton",
        compiler_params=_compiler_params(num_warps),
        interpret=interpret,
        name="sdf_march_fwd",
    )(params, view, pix0)


@partial(jax.jit, static_argnames=("meta", "cfg", "want_color", "interpret",
                                   "block", "num_warps"))
def _backward(params, view, pix0, *g, meta, cfg, want_color, interpret,
              block, num_warps):
    programs = g[0].shape[0] // block
    n_out = _n_scalars(meta) + N_VIEW
    part, _ = pl.pallas_call(
        partial(_backward_kernel, meta=meta, cfg=cfg, want_color=want_color,
                block=block),
        grid=(programs,),
        in_specs=[pl.BlockSpec()] * 3
        + [pl.BlockSpec((block,), lambda i: (i,))] * len(g),
        out_specs=[pl.BlockSpec(), pl.BlockSpec()],
        out_shape=[
            jax.ShapeDtypeStruct((programs, n_out), jnp.float32),
            # Depth history: (program, march step, pixel).
            jax.ShapeDtypeStruct(
                (programs, max(cfg.depth_iterations - 1, 1), block),
                jnp.float32,
            ),
        ],
        backend="triton",
        compiler_params=_compiler_params(num_warps),
        interpret=interpret,
        name="sdf_march_bwd",
    )(params, view, pix0, *g)
    return jnp.sum(part, axis=0)


# ---------------------------------------------------------------------------
# Differentiable entry: render ``n_rows`` image rows starting at flat pixel
# ``pix0`` (traced OK). The whole image is the case pix0 = 0, n_rows = H.
# ---------------------------------------------------------------------------


@partial(jax.custom_vjp, nondiff_argnums=(3, 4, 5, 6))
def _render_rows(sdf, view, pix0, cfg, n_rows, want_color, interpret):
    params, meta = _pack_params(sdf)
    local_npix = n_rows * cfg.width
    out = _forward(
        params, view, jnp.asarray(pix0, jnp.int32).reshape(1), meta=meta,
        cfg=cfg, want_color=want_color, local_npix=local_npix,
        interpret=interpret, block=BLOCK, num_warps=NUM_WARPS,
    )
    planes = [o[:local_npix].reshape(n_rows, cfg.width) for o in out]
    return jnp.stack(planes, axis=-1) if want_color else planes[0]


def _render_rows_fwd(sdf, view, pix0, cfg, n_rows, want_color, interpret):
    out = _render_rows(sdf, view, pix0, cfg, n_rows, want_color, interpret)
    return out, (sdf, view, pix0)


def _render_rows_bwd(cfg, n_rows, want_color, interpret, res, g):
    sdf, view, pix0 = res
    params, meta = _pack_params(sdf)
    local_npix = n_rows * cfg.width
    padded = -(-local_npix // BLOCK) * BLOCK
    g = jnp.asarray(g, jnp.float32).reshape(local_npix, -1)
    # Padding pixels get zero cotangent, so their duplicated marches add
    # nothing.
    planes = [
        jnp.pad(g[:, c], (0, padded - local_npix)) for c in range(g.shape[1])
    ]
    tot = _backward(
        params, view, jnp.asarray(pix0, jnp.int32).reshape(1), *planes,
        meta=meta, cfg=cfg, want_color=want_color, interpret=interpret,
        block=BLOCK, num_warps=NUM_WARPS,
    )
    n_params = _n_scalars(meta)
    g_pix0 = np.zeros(np.shape(pix0), jax.dtypes.float0)
    return _unpack_grads(meta, tot), tot[n_params:], g_pix0


_render_rows.defvjp(_render_rows_fwd, _render_rows_bwd)


def view_to_kernel_view(view, cfg):
    """view matrix -> the kernels' (N_VIEW,) view vector: inverse(view @
    proj) row-major, then the camera position. Plain jnp, so autodiff
    carries the kernel's view cotangent back to the view matrix."""
    from sdfkit.utils import camera as cam_mod

    view = jnp.asarray(view, jnp.float32)
    cam_pos = jnp.linalg.inv(view)[3, :3]
    proj = cam_mod.perspective_fov(
        jnp.deg2rad(jnp.float32(cfg.vfov_degrees)),
        cfg.width / cfg.height,
        cfg.near,
        cfg.far,
    )
    ivp = jnp.linalg.inv(jnp.matmul(view, proj, precision="highest"))
    return jnp.concatenate([ivp.reshape(16), cam_pos])


def render_image_fused(sdf, view, cfg, interpret: bool = False):
    """Fused (H, W, 3) render of ``view``. ``interpret`` runs the kernels in
    the Pallas interpreter instead of compiling them for the GPU."""
    kv = view_to_kernel_view(view, cfg)
    return _render_rows(sdf, kv, 0, cfg, cfg.height, True, interpret)


def render_depth_image_fused(sdf, view, cfg, interpret: bool = False):
    """Fused (H, W) depth render."""
    kv = view_to_kernel_view(view, cfg)
    return _render_rows(sdf, kv, 0, cfg, cfg.height, False, interpret)


def render_rows_fused(sdf, kview, pix0, cfg, n_rows, interpret: bool = False,
                      depth_only: bool = False):
    """Fused render of ``n_rows`` rows starting at flat pixel ``pix0``
    (traced OK) of the cfg.width x cfg.height image — the per-device worker
    under shard_map (the reference's row bands, RayMarcher.cs:50-61).
    ``kview`` comes from view_to_kernel_view(view, cfg). Returns
    (n_rows, W, 3), or (n_rows, W) depth."""
    return _render_rows(sdf, kview, pix0, cfg, n_rows, not depth_only,
                        interpret)
