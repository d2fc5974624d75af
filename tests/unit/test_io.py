"""IO round-trip tests: native + fallback Gadget reader, PLY reader, BMP
writer (analogs of ref helper/read_gadget.cuh, helper/ply.c,
helper/images.hpp usage)."""

import numpy as np
import pytest

from grace_jax.io import native
from grace_jax.io.gadget import _np_read, read_gadget_gas, write_gadget_gas
from grace_jax.io.images import to_colormap, write_bmp
from grace_jax.io.ply import _py_read, read_ply


def test_gadget_roundtrip(tmp_path, rng):
    n = 1000
    xyzh = np.concatenate(
        [rng.random((n, 3)), 0.01 + 0.1 * rng.random((n, 1))], axis=1
    ).astype(np.float32)
    path = str(tmp_path / "snap.gdt")
    write_gadget_gas(path, xyzh)
    back = read_gadget_gas(path)
    np.testing.assert_array_equal(back, xyzh)
    # numpy fallback agrees with the native reader
    np.testing.assert_array_equal(_np_read(path), xyzh)


def test_native_library_builds():
    assert native.load() is not None, "native IO library failed to build"


def test_ply_ascii_and_fallback(tmp_path):
    content = """ply
format ascii 1.0
element vertex 4
property float x
property float y
property float z
element face 2
property list uchar int vertex_indices
end_header
0 0 0
1 0 0
1 1 0
0 1 0
3 0 1 2
3 0 2 3
"""
    path = str(tmp_path / "quad.ply")
    with open(path, "w") as f:
        f.write(content)
    v, t = read_ply(path)
    assert v.shape == (4, 3) and t.shape == (2, 3)
    np.testing.assert_array_equal(t, [[0, 1, 2], [0, 2, 3]])
    v2, t2 = _py_read(path)
    np.testing.assert_array_equal(v, v2)
    np.testing.assert_array_equal(t, t2)


def test_ply_binary(tmp_path):
    header = (b"ply\nformat binary_little_endian 1.0\n"
              b"element vertex 3\nproperty float x\nproperty float y\n"
              b"property float z\nelement face 1\n"
              b"property list uchar int vertex_indices\nend_header\n")
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    path = str(tmp_path / "tri.ply")
    with open(path, "wb") as f:
        f.write(header)
        f.write(verts.tobytes())
        f.write(np.uint8(3).tobytes())
        f.write(np.array([0, 1, 2], np.int32).tobytes())
    v, t = read_ply(path)
    np.testing.assert_array_equal(v, verts)
    np.testing.assert_array_equal(t, [[0, 1, 2]])
    v2, t2 = _py_read(path)
    np.testing.assert_array_equal(v2, verts)
    np.testing.assert_array_equal(t2, [[0, 1, 2]])


def test_bmp_writer(tmp_path, rng):
    img = (rng.random((17, 23)) * 5).astype(np.float32)
    rgb = to_colormap(img)
    path = str(tmp_path / "out.bmp")
    write_bmp(path, rgb)
    raw = open(path, "rb").read()
    assert raw[:2] == b"BM"
    # BMP size field matches
    assert int.from_bytes(raw[2:6], "little") == len(raw)
    w = int.from_bytes(raw[18:22], "little")
    h = int.from_bytes(raw[22:26], "little")
    assert (w, h) == (23, 17)


def test_gadget_sharded_read(tmp_path, rng):
    from grace_jax.io.gadget import read_gadget_gas_shard

    n = 1003  # deliberately not divisible
    xyzh = np.concatenate(
        [rng.random((n, 3)), 0.01 + 0.1 * rng.random((n, 1))], axis=1
    ).astype(np.float32)
    path = str(tmp_path / "snap.gdt")
    write_gadget_gas(path, xyzh)
    shards = [read_gadget_gas_shard(path, s, 4) for s in range(4)]
    back = np.concatenate(shards)
    np.testing.assert_array_equal(back, xyzh)


def test_parse_profiles_log():
    import importlib.util, pathlib
    spec = importlib.util.spec_from_file_location(
        "parse_profiles",
        pathlib.Path(__file__).resolve().parents[2] / "tools" / "parse_profiles.py")
    pp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pp)
    recs = pp.parse_log("a_ms: 1.5\nrays: 100\n\nN: 2048\na_ms: 2.5\n")
    assert recs == [{"a_ms": 1.5, "rays": 100}, {"N": 2048, "a_ms": 2.5}]
    merged = pp.merge(["x"], [recs])
    assert merged["a_ms"]["x"] == [1.5, 2.5]
    assert "2048" in pp.table(merged, ["x"])
