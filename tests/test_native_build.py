"""The native library is keyed by a hash of its sources, flags and host, so
a stale or foreign build in the checkout is never loaded."""

import ctypes
import os
import shutil

import pytest

from sdfkit import native

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain")

SRC = 'extern "C" int answer() { return %d; }\n'


def _write(path, value):
    with open(path, "w") as f:
        f.write(SRC % value)


def _answer(lib):
    return ctypes.CDLL(lib).answer()


def test_same_sources_reuse_the_build(tmp_path):
    src = tmp_path / "k.cc"
    _write(src, 1)
    lib = native._build([str(src)], [], str(tmp_path), "_k")
    mtime = os.path.getmtime(lib)
    assert native._build([str(src)], [], str(tmp_path), "_k") == lib
    assert os.path.getmtime(lib) == mtime
    assert _answer(lib) == 1


def test_changed_source_rebuilds(tmp_path):
    src = tmp_path / "k.cc"
    _write(src, 1)
    first = native._build([str(src)], [], str(tmp_path), "_k")
    _write(src, 2)
    second = native._build([str(src)], [], str(tmp_path), "_k")
    assert second != first
    assert _answer(second) == 2
    # The stale build is removed.
    assert not os.path.exists(first)


def test_foreign_library_is_ignored(tmp_path):
    # A library of the old unkeyed name, or one built on another host, is
    # never picked up: only the hash-keyed name is loaded.
    src = tmp_path / "k.cc"
    _write(src, 3)
    (tmp_path / "_k.so").write_bytes(b"not a library")
    lib = native._build([str(src)], [], str(tmp_path), "_k")
    assert os.path.basename(lib) != "_k.so"
    assert _answer(lib) == 3


def test_host_is_part_of_the_key(tmp_path, monkeypatch):
    src = tmp_path / "k.cc"
    _write(src, 4)
    here = native._build_key([str(src)], [], ["-O3"])
    monkeypatch.setattr(native, "_host_id", lambda: "another-cpu")
    assert native._build_key([str(src)], [], ["-O3"]) != here


def test_flags_are_part_of_the_key(tmp_path):
    src = tmp_path / "k.cc"
    _write(src, 5)
    assert (native._build_key([str(src)], [], ["-O3"])
            != native._build_key([str(src)], [], ["-O2"]))
