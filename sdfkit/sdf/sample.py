"""Batched point-sampling driver.

The reference chunks an arbitrary point array into fixed-size batches
(default 2048) and evaluates them serially or via Parallel.For
(reference: SdfEx.Sample, Sdf.cs:22-47; SdfConfig.DefaultBatchSize,
Sdf.cs:11-14). On the device the same contract — bounded working set regardless of
point count — maps to ``lax.map`` over statically-shaped batches inside one
jit: XLA compiles the batch body once and loops it on device, so N points
cost O(batch_size) memory, not O(N). For multi-device sampling see
``sdfkit.parallel`` (points sharded over the mesh instead).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

DEFAULT_BATCH_SIZE = 2048  # SdfConfig.DefaultBatchSize (Sdf.cs:13)


@partial(jax.jit, static_argnums=(2,))
def _sample_impl(sdf, points, batch_size: int):
    n = points.shape[0]
    nbatch = (n + batch_size - 1) // batch_size
    padded = jnp.pad(points, ((0, nbatch * batch_size - n), (0, 0)))
    out = jax.lax.map(sdf, padded.reshape(nbatch, batch_size, 3))
    return out.reshape(nbatch * batch_size, 4)[:n]


def sample(sdf, points, batch_size: int = DEFAULT_BATCH_SIZE):
    """Evaluate ``sdf`` at ``points`` in fixed-size batches.

    ``points``: (N, 3) float32. Returns (N, 4): RGB in [..., :3], signed
    distance in [..., 3] (the reference's Vector4 convention). The final
    partial batch is zero-padded on device and sliced away, matching the
    reference's short remainder batch (Sdf.cs:29-31).
    """
    points = jnp.asarray(points, jnp.float32)
    if points.ndim != 2 or points.shape[-1] != 3:
        raise ValueError(f"points must be (N, 3), got {points.shape}")
    batch_size = int(min(batch_size, max(points.shape[0], 1)))
    return _sample_impl(sdf, points, batch_size)
