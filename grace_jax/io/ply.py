"""Stanford PLY triangle-mesh reader (analog of ref tests/helper/ply.c, the
3.3k-LoC vendored PLY library used by render_triangle).

Returns (vertices f32[V, 3], triangles i32[T, 3]); quads are fan-split.
Native C++ fast path with a numpy/python fallback for ascii and
binary_little_endian files.
"""

from __future__ import annotations

import numpy as np

from grace_jax.io import native


def read_ply(path: str):
    lib = native.load()
    if lib is not None:
        import ctypes

        nv = ctypes.c_long()
        nf = ctypes.c_long()
        rc = lib.grace_ply_counts(path.encode(), ctypes.byref(nv), ctypes.byref(nf))
        if rc != 0:
            raise IOError(f"failed to parse PLY header of {path} (rc={rc})")
        verts = np.empty((nv.value, 3), np.float32)
        max_tris = 2 * max(nf.value, 1)
        tris = np.empty((max_tris, 3), np.int32)
        n_tris = lib.grace_ply_read(
            path.encode(),
            verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            max_tris,
        )
        if n_tris < 0:
            raise IOError(f"failed to read PLY data from {path} (rc={n_tris})")
        return verts, tris[:n_tris].copy()
    return _py_read(path)


def _py_read(path: str):
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            header.append(line)
            if line == "end_header":
                break
        data_off = f.tell()
    fmt = next(l.split()[1] for l in header if l.startswith("format"))
    n_verts = n_faces = 0
    vert_props = []
    face_list = ("uchar", "int")
    cur = None
    for l in header:
        t = l.split()
        if not t:
            continue
        if t[0] == "element":
            cur = t[1]
            if t[1] == "vertex":
                n_verts = int(t[2])
            elif t[1] == "face":
                n_faces = int(t[2])
        elif t[0] == "property" and cur == "vertex":
            vert_props.append(t[1])
        elif t[0] == "property" and cur == "face" and t[1] == "list":
            face_list = (t[2], t[3])

    np_type = {"char": np.int8, "uchar": np.uint8, "int8": np.int8, "uint8": np.uint8,
               "short": np.int16, "ushort": np.uint16, "int16": np.int16,
               "uint16": np.uint16, "int": np.int32, "uint": np.uint32,
               "int32": np.int32, "uint32": np.uint32, "float": np.float32,
               "float32": np.float32, "double": np.float64, "float64": np.float64}

    verts = np.empty((n_verts, 3), np.float32)
    tris = []
    if fmt == "ascii":
        with open(path, "r") as f:
            while f.readline().strip() != "end_header":
                pass
            for i in range(n_verts):
                vals = f.readline().split()
                verts[i] = [float(v) for v in vals[:3]]
            for _ in range(n_faces):
                vals = [int(v) for v in f.readline().split()]
                cnt, idx = vals[0], vals[1:]
                for k in range(2, cnt):
                    tris.append((idx[0], idx[k - 1], idx[k]))
    elif fmt == "binary_little_endian":
        rec = np.dtype([(f"p{i}", np_type[p]) for i, p in enumerate(vert_props)])
        with open(path, "rb") as f:
            f.seek(data_off)
            vr = np.frombuffer(f.read(rec.itemsize * n_verts), rec)
            for i in range(3):
                verts[:, i] = vr[f"p{i}"]
            ct = np.dtype(np_type[face_list[0]])
            it = np.dtype(np_type[face_list[1]])
            for _ in range(n_faces):
                cnt = int(np.frombuffer(f.read(ct.itemsize), ct)[0])
                idx = np.frombuffer(f.read(it.itemsize * cnt), it)
                for k in range(2, cnt):
                    tris.append((int(idx[0]), int(idx[k - 1]), int(idx[k])))
    else:
        raise IOError(f"unsupported PLY format {fmt}")
    return verts, np.asarray(tris, np.int32).reshape(-1, 3)
