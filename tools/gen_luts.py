"""One-off generator: parse the Lewiner MC33 lookup tables out of the
reference's Luts.cs (pure data, originally from scikit-image's
_marching_cubes_lewiner_luts.py) and emit them as a compact Python module.

Usage: python tools/gen_luts.py > sdfkit/mesh/_luts_data.py
"""

import re
import sys

SRC = "/root/reference/SdfKit/Luts.cs"

NAMES = [
    "edgesrelx", "edgesrely", "edgesrelz", "cases",
    "tiling1", "tiling2", "test3", "tiling3_1", "tiling3_2",
    "test4", "tiling4_1", "tiling4_2", "tiling5",
    "test6", "tiling6_1_1", "tiling6_1_2", "tiling6_2",
    "test7", "tiling7_1", "tiling7_2", "tiling7_3", "tiling7_4_1",
    "tiling7_4_2", "tiling8", "tiling9",
    "test10", "tiling10_1_1", "tiling10_1_1_", "tiling10_1_2",
    "tiling10_2", "tiling10_2_", "tiling11",
    "test12", "tiling12_1_1", "tiling12_1_1_", "tiling12_1_2",
    "tiling12_2", "tiling12_2_",
    "test13", "subconfig13", "tiling13_1", "tiling13_1_",
    "tiling13_2", "tiling13_2_", "tiling13_3", "tiling13_3_",
    "tiling13_4", "tiling13_5_1", "tiling13_5_2", "tiling14",
]


def extract(text: str, name: str):
    m = re.search(
        r"sbyte\[[,]*\]\s+" + re.escape(name) + r"\s*=\s*", text
    )
    if not m:
        raise KeyError(name)
    i = text.index("{", m.end())
    depth = 0
    for j in range(i, len(text)):
        if text[j] == "{":
            depth += 1
        elif text[j] == "}":
            depth -= 1
            if depth == 0:
                break
    body = text[i : j + 1]
    body = re.sub(r"/\*.*?\*/", "", body, flags=re.S)
    body = re.sub(r"//[^\n]*", "", body)
    body = body.replace("{", "[").replace("}", "]")
    body = re.sub(r",\s*\]", "]", body)
    return eval(body)


def main():
    text = open(SRC).read()
    out = sys.stdout
    out.write(
        '"""Lewiner MC33 lookup tables (GENERATED by tools/gen_luts.py).\n\n'
        "Pure data, identical to scikit-image's _marching_cubes_lewiner_luts.py\n"
        "(BSD) and the reference SdfKit/Luts.cs. Do not edit by hand.\n"
        '"""\n\n# fmt: off\n'
    )
    for name in NAMES:
        data = extract(text, name)
        out.write(f"{name} = {data!r}\n")
    out.write("# fmt: on\n")


if __name__ == "__main__":
    main()
