"""Icosphere generation (the port's copy of `dlwpbench_tpu/grids/icosphere.py`,
numpy only) — replaces the reference's pymesh dependency
(`models/graphcast/utils/icospheres.py:23-66`).

Generates nested icospheres order 0..L by 4-way triangle subdivision with
midpoint projection to the unit sphere.  Vertices of order k are a prefix of
the vertices of order k+1 (new midpoints are appended), which the GraphCast
multimesh construction relies on (union of all orders' faces over the finest
vertex set, reference `utils/graph.py:100-121`).
"""

from __future__ import annotations

import functools

import numpy as np


def base_icosahedron() -> tuple[np.ndarray, np.ndarray]:
    """Unit icosahedron (12 vertices, 20 faces)."""
    p = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, p, 0], [1, p, 0], [-1, -p, 0], [1, -p, 0],
            [0, -1, p], [0, 1, p], [0, -1, -p], [0, 1, -p],
            [p, 0, -1], [p, 0, 1], [-p, 0, -1], [-p, 0, 1],
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    return verts, faces


def subdivide(verts: np.ndarray, faces: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One 4-way subdivision; new midpoint vertices are appended."""
    verts = list(map(tuple, verts))
    cache: dict[tuple[int, int], int] = {}

    def midpoint(a: int, b: int) -> int:
        key = (min(a, b), max(a, b))
        if key in cache:
            return cache[key]
        v = (np.asarray(verts[a]) + np.asarray(verts[b])) / 2.0
        v = tuple(v / np.linalg.norm(v))
        verts.append(v)
        cache[key] = len(verts) - 1
        return cache[key]

    new_faces = []
    for a, b, c in faces:
        ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
        new_faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
    return np.asarray(verts), np.asarray(new_faces, np.int64)


@functools.lru_cache(maxsize=None)
def icospheres(max_order: int) -> dict:
    """Dict with order_{k}_{vertices,faces,face_centroid} for k in 0..max_order
    (same key layout as the reference's icospheres json)."""
    verts, faces = base_icosahedron()
    out = {}
    for order in range(max_order + 1):
        if order > 0:
            verts, faces = subdivide(verts, faces)
        centroids = verts[faces].mean(axis=1)
        centroids /= np.linalg.norm(centroids, axis=1, keepdims=True)
        out[f"order_{order}_vertices"] = verts.copy()
        out[f"order_{order}_faces"] = faces.copy()
        out[f"order_{order}_face_centroid"] = centroids
    return out
