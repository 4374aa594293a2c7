"""Image and artifact IO: TGA (reference parity, VectorData.cs:570-619,
244-276), PNG (stdlib-zlib, no dependencies)."""

from sdfkit.io.png import read_png, write_depth_png, write_png
from sdfkit.io.tga import read_tga, write_depth_tga, write_tga

__all__ = [
    "read_png",
    "read_tga",
    "write_depth_png",
    "write_depth_tga",
    "write_png",
    "write_tga",
]
