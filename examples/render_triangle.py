"""Shaded triangle-mesh render to BMP (analog of ref tests/render_triangle/
render_triangle.cu:25-111, which reads the Stanford dragon PLY).

Usage:
    python examples/render_triangle.py [mesh.ply] [resolution]

Without a PLY argument a procedural torus mesh is generated.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np


def torus_mesh(n_u=64, n_v=32, R=1.0, r=0.4):
    u = np.linspace(0, 2 * np.pi, n_u, endpoint=False)
    v = np.linspace(0, 2 * np.pi, n_v, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    x = (R + r * np.cos(vv)) * np.cos(uu)
    y = (R + r * np.cos(vv)) * np.sin(uu)
    z = r * np.sin(vv)
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)

    def vid(i, j):
        return (i % n_u) * n_v + (j % n_v)

    tris = []
    for i in range(n_u):
        for j in range(n_v):
            a, b, c, d = vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)
            tris.append((a, b, c))
            tris.append((a, c, d))
    return verts[np.asarray(tris, np.int32)]


def main():
    from grace_jax.io.images import to_colormap, write_bmp
    from grace_jax.models.triangle import render_triangles

    ply = sys.argv[1] if len(sys.argv) > 1 and sys.argv[1].endswith(".ply") else None
    off = 1 if ply else 0
    res = int(sys.argv[1 + off]) if len(sys.argv) > 1 + off else 512
    if ply:
        from grace_jax.io.ply import read_ply

        verts, faces = read_ply(ply)
        tris = verts[faces]
        print(f"{faces.shape[0]} triangles from {ply}")
    else:
        tris = torus_mesh()
        print(f"procedural torus: {tris.shape[0]} triangles")

    img = np.array(render_triangles(tris, resolution=res))
    write_bmp("render.bmp", to_colormap(img))
    print(f"wrote render.bmp ({res}x{res})")


if __name__ == "__main__":
    main()
