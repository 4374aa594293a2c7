#!/usr/bin/env python
"""Generate sdfkit/native/_mc_luts.h from sdfkit.mesh.luts.

The C++ host kernels (native/mc_host.cc) need the same MC33 lookup tables the
Python sparse phase uses (sdfkit/mesh/luts.py, themselves generated from
the reference's constant data by tools/gen_luts.py — see the (b) unavoidable-
similarity note there: pure constant data identical in any correct MC33).
Emitting them from the in-repo luts module keeps the two implementations
pinned to one source of truth.

Run: python tools/gen_luts_header.py   (rewrites the header in place)
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from sdfkit.mesh import luts  # noqa: E402

TABLES = [
    # (C name, python name, C element type)
    ("CASES", "cases", "int8_t"),
    ("TILING1", "tiling1", "int8_t"),
    ("TILING2", "tiling2", "int8_t"),
    ("TEST3", "test3", "int8_t"),
    ("TILING3_1", "tiling3_1", "int8_t"),
    ("TILING3_2", "tiling3_2", "int8_t"),
    ("TEST4", "test4", "int8_t"),
    ("TILING4_1", "tiling4_1", "int8_t"),
    ("TILING4_2", "tiling4_2", "int8_t"),
    ("TILING5", "tiling5", "int8_t"),
    ("TEST6", "test6", "int8_t"),
    ("TILING6_1_1", "tiling6_1_1", "int8_t"),
    ("TILING6_1_2", "tiling6_1_2", "int8_t"),
    ("TILING6_2", "tiling6_2", "int8_t"),
    ("TEST7", "test7", "int8_t"),
    ("TILING7_1", "tiling7_1", "int8_t"),
    ("TILING7_2", "tiling7_2", "int8_t"),
    ("TILING7_3", "tiling7_3", "int8_t"),
    ("TILING7_4_1", "tiling7_4_1", "int8_t"),
    ("TILING7_4_2", "tiling7_4_2", "int8_t"),
    ("TILING8", "tiling8", "int8_t"),
    ("TILING9", "tiling9", "int8_t"),
    ("TEST10", "test10", "int8_t"),
    ("TILING10_1_1", "tiling10_1_1", "int8_t"),
    ("TILING10_1_1_", "tiling10_1_1_", "int8_t"),
    ("TILING10_1_2", "tiling10_1_2", "int8_t"),
    ("TILING10_2", "tiling10_2", "int8_t"),
    ("TILING10_2_", "tiling10_2_", "int8_t"),
    ("TILING11", "tiling11", "int8_t"),
    ("TEST12", "test12", "int8_t"),
    ("TILING12_1_1", "tiling12_1_1", "int8_t"),
    ("TILING12_1_1_", "tiling12_1_1_", "int8_t"),
    ("TILING12_1_2", "tiling12_1_2", "int8_t"),
    ("TILING12_2", "tiling12_2", "int8_t"),
    ("TILING12_2_", "tiling12_2_", "int8_t"),
    ("TEST13", "test13", "int8_t"),
    ("SUBCONFIG13", "subconfig13", "int8_t"),
    ("TILING13_1", "tiling13_1", "int8_t"),
    ("TILING13_1_", "tiling13_1_", "int8_t"),
    ("TILING13_2", "tiling13_2", "int8_t"),
    ("TILING13_2_", "tiling13_2_", "int8_t"),
    ("TILING13_3", "tiling13_3", "int8_t"),
    ("TILING13_3_", "tiling13_3_", "int8_t"),
    ("TILING13_4", "tiling13_4", "int8_t"),
    ("TILING13_5_1", "tiling13_5_1", "int8_t"),
    ("TILING13_5_2", "tiling13_5_2", "int8_t"),
    ("TILING14", "tiling14", "int8_t"),
    ("EDGESRELX", "edgesrelx", "int8_t"),
    ("EDGESRELY", "edgesrely", "int8_t"),
    ("EDGESRELZ", "edgesrelz", "int8_t"),
    ("CORNER_DX", "CORNER_DX", "int8_t"),
    ("CORNER_DY", "CORNER_DY", "int8_t"),
    ("CORNER_DZ", "CORNER_DZ", "int8_t"),
    ("OFFSET_TO_MC", "OFFSET_TO_MC", "int8_t"),
    ("KEY_OX", "KEY_OX", "int8_t"),
    ("KEY_OY", "KEY_OY", "int8_t"),
    ("KEY_OZ", "KEY_OZ", "int8_t"),
    ("KEY_J", "KEY_J", "int8_t"),
    ("EDGE_P1", "EDGE_P1", "int8_t"),
    ("EDGE_P2", "EDGE_P2", "int8_t"),
    ("EDGE_MC1", "EDGE_MC1", "int8_t"),
    ("EDGE_MC2", "EDGE_MC2", "int8_t"),
    ("FACE_CORNERS", "FACE_CORNERS", "int8_t"),
    ("INT_T", "INT_T", "int8_t"),
    ("INT_B", "INT_B", "int8_t"),
    ("INT_C", "INT_C", "int8_t"),
    ("INT_D", "INT_D", "int8_t"),
]


def emit_table(out, cname: str, arr: np.ndarray, ctype: str) -> None:
    """Emit each table as a flat array plus row-stride macros ({name}_S{k} =
    elements to step one index along axis k, for k >= 1)."""
    flat = np.asarray(arr).reshape(-1)
    body = ", ".join(str(int(v)) for v in flat.tolist())
    shape = ", ".join(str(d) for d in arr.shape)
    out.append(f"// {cname} shape: ({shape})")
    out.append(f"static const {ctype} {cname}[{flat.size}] = {{{body}}};")
    if arr.ndim >= 2:
        # {name}_S{k} = elements to step one index along axis k (row-major):
        # S0 = prod(shape[1:]), S1 = prod(shape[2:]), ...
        for k in range(arr.ndim - 1):
            st = int(np.prod(arr.shape[k + 1 :]))
            out.append(f"#define {cname}_S{k} {st}")
    out.append("")


def main() -> None:
    lines = [
        "// AUTO-GENERATED by tools/gen_luts_header.py — do not edit.",
        "// MC33 lookup tables from sdfkit/mesh/luts.py (constant data,",
        "// same tables as scikit-image/the reference; see luts.py header).",
        "#pragma once",
        "#include <cstdint>",
        "",
    ]
    for cname, pyname, ctype in TABLES:
        arr = np.asarray(getattr(luts, pyname))
        emit_table(lines, cname, arr, ctype)
    path = os.path.join(
        os.path.dirname(__file__), "..", "sdfkit", "native", "_mc_luts.h"
    )
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {os.path.normpath(path)} ({len(lines)} lines)")


if __name__ == "__main__":
    main()
