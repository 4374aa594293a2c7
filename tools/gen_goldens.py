"""(Re)generate the committed image goldens in tests/goldens/.

The reference writes TGA/depth artifacts per test run (reference:
Tests/RayMarcherTests.cs:94-159); here the equivalent renders are generated
ONCE on the CPU backend (same backend the tests run on, so comparisons are
deterministic) and committed, pinning whole-image shading that the scalar
depth probes can't.

Run from the repo root:  python tools/gen_goldens.py
"""

import os
import pathlib
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax  # noqa: E402


def _force_cpu() -> None:
    """Select the CPU backend even if one was already initialized (same
    public teardown as tests/conftest.py)."""
    import jax.extend.backend

    jax.extend.backend.clear_backends()
    jax.config.update("jax_platforms", "cpu")


_force_cpu()

import numpy as np  # noqa: E402

import sdfkit as sk  # noqa: E402
from sdfkit.io.png import write_png  # noqa: E402

GOLDEN_DIR = pathlib.Path(__file__).resolve().parents[1] / "tests" / "goldens"


def sphere_repeat_scene():
    from bench import sphere_repeat_scene as scene

    return scene()


def main():
    import jax

    assert jax.devices()[0].platform == "cpu", (
        "goldens must be generated on the CPU backend (got %s)" % jax.devices()
    )
    GOLDEN_DIR.mkdir(exist_ok=True)

    # Depth goldens, 50x30, default camera (0,0,5) -> origin
    # (reference: Tests/RayMarcherTests.cs:10-75).
    for name, expr in (
        ("sphere", sk.sphere(1.0)),
        ("box", sk.box(1.0)),
        ("plane", sk.plane_xy()),
    ):
        depth = np.asarray(sk.render_depth(expr, 50, 30), np.float32)
        np.save(GOLDEN_DIR / f"{name}_depth_50x30.npy", depth)
        print(f"{name}_depth_50x30.npy  center={depth[15, 25]:.4f}")

    # SphereRepeat RGB golden, 192x108, camera (-2,2,4)
    # (reference: Tests/RayMarcherTests.cs:94-159 renders this scene/size).
    img = np.asarray(
        sk.render(sphere_repeat_scene(), 192, 108, camera_position=(-2.0, 2.0, 4.0))
    )
    write_png(str(GOLDEN_DIR / "sphere_repeat_192x108.png"), img)
    print("sphere_repeat_192x108.png  mean=%.4f" % img.mean())


if __name__ == "__main__":
    main()
