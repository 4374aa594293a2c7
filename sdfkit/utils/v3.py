"""Structure-of-arrays 3-vector used throughout the compute path.

The reference (SdfKit) stores points as interleaved ``Vector3``/``Vector4``
structs (reference: SdfKit/VectorData.cs). Here each component is its own
array of identical shape (structure-of-arrays), so every elementwise op works
on whole contiguous arrays and no lane is spent on a trailing dimension of 3.
``V3`` works transparently for any component shape — scalars, ``(N,)``
kernel blocks or ``(H, W)`` images — so the same SDF expression code runs in
plain jnp and inside Pallas kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

Array = Any


class ScalarArray:
    """A small array held as separate scalars (an object ndarray of traced
    values). Indexing returns those scalars without any slicing op: the GPU
    render kernels rebuild a scene's parameter leaves this way from scalar
    loads, since Triton lowers no array slice."""

    def __init__(self, items: np.ndarray):
        self.items = items

    @property
    def shape(self):
        return self.items.shape

    @property
    def ndim(self):
        return self.items.ndim

    def __getitem__(self, idx):
        r = self.items[idx]
        if isinstance(r, np.ndarray):
            return ScalarArray(r) if r.ndim else r.item()
        return r


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class V3:
    """A 3-vector whose components are arrays of identical shape."""

    x: Array
    y: Array
    z: Array

    # -- pytree -----------------------------------------------------------
    def tree_flatten(self):
        return (self.x, self.y, self.z), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    # -- constructors -----------------------------------------------------
    @staticmethod
    def of(x, y, z) -> "V3":
        return V3(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))

    @staticmethod
    def full(value, like: Array | None = None) -> "V3":
        v = jnp.asarray(value)
        if like is not None:
            v = jnp.broadcast_to(v, jnp.shape(like)).astype(jnp.result_type(like, v))
        return V3(v, v, v)

    @staticmethod
    def splat(vec) -> "V3":
        """From a length-3 array-like (a 'constant' vector)."""
        v = vec if isinstance(vec, ScalarArray) else jnp.asarray(vec, jnp.float32)
        return V3(v[..., 0], v[..., 1], v[..., 2])

    @staticmethod
    def from_array(p: Array) -> "V3":
        """From an (..., 3) array."""
        return V3(p[..., 0], p[..., 1], p[..., 2])

    def to_array(self) -> Array:
        return jnp.stack(jnp.broadcast_arrays(self.x, self.y, self.z), axis=-1)

    # -- arithmetic -------------------------------------------------------
    def _coerce(self, o):
        if isinstance(o, V3):
            return o
        return V3(o, o, o)

    def __add__(self, o):
        o = self._coerce(o)
        return V3(self.x + o.x, self.y + o.y, self.z + o.z)

    __radd__ = __add__

    def __sub__(self, o):
        o = self._coerce(o)
        return V3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __rsub__(self, o):
        o = self._coerce(o)
        return V3(o.x - self.x, o.y - self.y, o.z - self.z)

    def __mul__(self, o):
        o = self._coerce(o)
        return V3(self.x * o.x, self.y * o.y, self.z * o.z)

    __rmul__ = __mul__

    def __truediv__(self, o):
        o = self._coerce(o)
        return V3(self.x / o.x, self.y / o.y, self.z / o.z)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    # -- vector ops -------------------------------------------------------
    def dot(self, o: "V3") -> Array:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "V3") -> "V3":
        return V3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def length_sq(self) -> Array:
        return self.dot(self)

    def length(self) -> Array:
        return jnp.sqrt(self.length_sq())

    def zero_safe_length(self) -> Array:
        """length() with a finite backward at the exact zero vector.

        Needed where the zero vector occurs on an open region — e.g. the box
        SDF's exterior term ``|max(wd, 0)|`` is identically zero inside the
        box, so the correct (sub)gradient there is 0, but sqrt'(0) is inf and
        reverse mode turns it into NaN for every ray that steps inside. The
        double-where keeps the forward value bit-identical."""
        ssq = self.length_sq()
        zero = ssq == 0
        return jnp.where(zero, 0.0, jnp.sqrt(jnp.where(zero, 1.0, ssq)))

    def normalize(self) -> "V3":
        """Matches reference Vector3.Normalize: straight divide (no epsilon)."""
        return self / self.length()

    def safe_normalize(self, eps: float = 1e-30) -> "V3":
        """Normalize with a floor *inside* the sqrt: identical to normalize()
        for any vector with |v|^2 > eps, but maps the zero vector to zero with
        a NaN-free backward. The floor must sit under the sqrt — sqrt'(0) is
        inf, and even a downstream maximum() leaks NaN through 0*inf in
        reverse mode (rays that miss have an exactly-zero finite-difference
        normal)."""
        inv = jax.lax.rsqrt(jnp.maximum(self.length_sq(), eps))
        return self * inv

    def abs(self) -> "V3":
        return V3(jnp.abs(self.x), jnp.abs(self.y), jnp.abs(self.z))

    def min(self, o) -> "V3":
        o = self._coerce(o)
        return V3(
            jnp.minimum(self.x, o.x), jnp.minimum(self.y, o.y), jnp.minimum(self.z, o.z)
        )

    def max(self, o) -> "V3":
        o = self._coerce(o)
        return V3(
            jnp.maximum(self.x, o.x), jnp.maximum(self.y, o.y), jnp.maximum(self.z, o.z)
        )

    def vmax(self) -> Array:
        """Max over the 3 components (reference: VectorOps.VMax, VectorData.cs:860)."""
        return jnp.maximum(self.x, jnp.maximum(self.y, self.z))

    def vmin(self) -> Array:
        return jnp.minimum(self.x, jnp.minimum(self.y, self.z))

    def where(self, mask, other: "V3") -> "V3":
        """Select self where mask else other."""
        o = self._coerce(other)
        return V3(
            jnp.where(mask, self.x, o.x),
            jnp.where(mask, self.y, o.y),
            jnp.where(mask, self.z, o.z),
        )

    @property
    def shape(self):
        return jnp.broadcast_shapes(
            jnp.shape(self.x), jnp.shape(self.y), jnp.shape(self.z)
        )


def vmod(a: Array, b: Array) -> Array:
    """Floor-mod matching the reference: ``a - b*floor(a/b)``
    (reference: VectorOps.Mod, VectorData.cs:697-698)."""
    return a - b * jnp.floor(a / b)
