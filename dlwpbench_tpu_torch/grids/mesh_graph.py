"""GraphCast graph construction (multimesh, grid2mesh, mesh2grid) in numpy
(the port's copy of `dlwpbench_tpu/grids/mesh_graph.py`: the same arrays,
bit for bit).

Reference: `models/graphcast/utils/graph.py` + `graph_utils.py` (DGL-based).
All graphs are plain numpy arrays — (src, dst) index vectors plus edge/node
feature matrices — which the models keep on the device as static tables
driving the message passing of `ops/graph_ops.py` (no graph library needed).

Feature conventions (reference `graph_utils.py:89-176`):
- edge features: displacement of src from dst expressed in a local coordinate
  system rotated so dst sits at lat=0, lon=0 (azimuthal then polar rotation),
  concatenated with the displacement norm, all normalized by the max norm
  over the graph -> 4 features;
- node features: [cos(lat), sin(lon), cos(lon)] -> 3 features.

Topology (reference `graph.py:100-233`):
- multimesh: union of the faces of all icosphere orders 0..L over the order-L
  vertex set, bidirected, deduplicated;
- g2m: for each grid point, its <=4 nearest mesh vertices within
  0.6 * (max order-L mesh edge length);
- m2g: the 3 vertices of the order-L face whose centroid is nearest to the
  grid point.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
from scipy.spatial import cKDTree

from dlwpbench_tpu_torch.grids.icosphere import icospheres


class GraphArrays(NamedTuple):
    src: np.ndarray  # [E] int32 (indices into src node set)
    dst: np.ndarray  # [E] int32 (indices into dst node set)
    edge_feat: np.ndarray  # [E, 4] float32
    n_src: int
    n_dst: int


def latlon2xyz(latlon: np.ndarray) -> np.ndarray:
    """[N, 2] degrees -> [N, 3] unit xyz (reference `graph_utils.py:177-199`)."""
    lat = np.deg2rad(latlon[:, 0])
    lon = np.deg2rad(latlon[:, 1])
    return np.stack(
        [np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon), np.sin(lat)], -1
    )


def xyz2latlon(xyz: np.ndarray) -> np.ndarray:
    """[N, 3] -> [N, 2] radians (lat, lon)."""
    lat = np.arcsin(np.clip(xyz[:, 2], -1, 1))
    lon = np.arctan2(xyz[:, 1], xyz[:, 0])
    return np.stack([lat, lon], -1)


def _rot_z(theta):
    c, s = np.cos(theta), np.sin(theta)
    z = np.zeros_like(c)
    o = np.ones_like(c)
    return np.stack(
        [np.stack([c, -s, z], -1), np.stack([s, c, z], -1), np.stack([z, z, o], -1)],
        -2,
    )


def _rot_y(theta):
    c, s = np.cos(theta), np.sin(theta)
    z = np.zeros_like(c)
    o = np.ones_like(c)
    return np.stack(
        [np.stack([c, z, s], -1), np.stack([z, o, z], -1), np.stack([-s, z, c], -1)],
        -2,
    )


def edge_features_local(
    src_pos: np.ndarray, dst_pos: np.ndarray, normalize: bool = True
) -> np.ndarray:
    """Rotated-local-coordinate displacement + norm (4 features per edge)."""
    dst_latlon = xyz2latlon(dst_pos)
    lat, lon = dst_latlon[:, 0], dst_latlon[:, 1]
    # azimuthal rotation: bring dst to lon=0 (y=0); then polar: lat=0
    Rz = _rot_z(-lon)
    s1 = np.einsum("eij,ej->ei", Rz, src_pos)
    d1 = np.einsum("eij,ej->ei", Rz, dst_pos)
    theta_pol = -np.arcsin(np.clip(d1[:, 2], -1, 1))
    Ry = _rot_y(-theta_pol)
    s2 = np.einsum("eij,ej->ei", Ry, s1)
    d2 = np.einsum("eij,ej->ei", Ry, d1)
    assert np.allclose(d2[:, 1], 0, atol=1e-6) and np.allclose(
        d2[:, 2], 0, atol=1e-6
    ), "local-coordinate rotation failed"
    disp = s2 - d2
    norm = np.linalg.norm(disp, axis=-1, keepdims=True)
    if normalize:
        m = norm.max()
        return np.concatenate([disp / m, norm / m], -1).astype(np.float32)
    return np.concatenate([disp, norm], -1).astype(np.float32)


def node_features(xyz: np.ndarray, unit: str = "rad") -> np.ndarray:
    """[cos(lat), sin(lon), cos(lon)] mesh node features.

    unit="rad" (default) is the sane encoding.  unit="deg_quirk" reproduces
    the reference exactly: its `add_node_features` feeds DEGREE values from
    `xyz2latlon` (default unit="deg") straight into cos/sin
    (`graph_utils.py:153-176,212-241`), so longitude wraps ~28 times over
    the sphere — kept only as a parity option.
    """
    ll = xyz2latlon(xyz)
    lat, lon = ll[:, 0], ll[:, 1]
    if unit == "deg_quirk":
        lat, lon = np.rad2deg(lat), np.rad2deg(lon)
    elif unit != "rad":
        raise ValueError(f"unknown unit: {unit!r}")
    return np.stack([np.cos(lat), np.sin(lon), np.cos(lon)], -1).astype(np.float32)


def _bidirect_dedup(src: np.ndarray, dst: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    a = np.concatenate([src, dst])
    b = np.concatenate([dst, src])
    edges = np.unique(np.stack([a, b], 1), axis=0)
    edges = edges[edges[:, 0] != edges[:, 1]]
    return edges[:, 0], edges[:, 1]


@functools.lru_cache(maxsize=None)
def build_graphcast_graphs(
    nlat: int, nlon: int, mesh_level: int = 3,
    grid_convention: str = "cell_centers",
    node_feat_unit: str = "rad",
):
    """Returns (mesh_graph, g2m, m2g, mesh_node_feat [V,3], mesh_pos [V,3],
    grid_latlon [N,2]).

    grid_convention:
    - "cell_centers" (default): WeatherBench cell centers, lats
      [-90+d/2, 90-d/2], lons [0, 360).
    - "pole_inclusive": the reference GraphCastNet's grid
      (`graph_cast_net.py:189-193`): lats linspace(-90, 90, nlat) including
      both poles, lons linspace(-180, 180, nlon+1)[1:].  Degenerate at the
      poles (all longitudes coincide) but needed for reference parity.
    """
    ico = icospheres(mesh_level)
    verts = ico[f"order_{mesh_level}_vertices"]
    faces_l = ico[f"order_{mesh_level}_faces"]
    V = len(verts)

    # --- multimesh: union of faces of all orders ---
    all_faces = np.concatenate(
        [ico[f"order_{k}_faces"] for k in range(mesh_level + 1)]
    )
    src = np.concatenate([all_faces[:, 0], all_faces[:, 1], all_faces[:, 2]])
    dst = np.concatenate([all_faces[:, 1], all_faces[:, 2], all_faces[:, 0]])
    src, dst = _bidirect_dedup(src, dst)
    mesh_ef = edge_features_local(verts[src], verts[dst])
    mesh_graph = GraphArrays(
        src.astype(np.int32), dst.astype(np.int32), mesh_ef, V, V
    )

    # --- lat-lon grid (row-major lat x lon) ---
    if grid_convention == "pole_inclusive":
        # float32 like the reference's torch.linspace grid so the NN
        # distance cut selects identical g2m edges
        lats = np.linspace(-90, 90, nlat, dtype=np.float32)
        lons = np.linspace(-180, 180, nlon + 1, dtype=np.float32)[1:]
    elif grid_convention == "cell_centers":
        dlat = 180.0 / nlat
        lats = np.linspace(-90 + dlat / 2, 90 - dlat / 2, nlat)
        lons = np.linspace(0, 360, nlon, endpoint=False)
    else:
        raise ValueError(f"unknown grid_convention: {grid_convention!r}")
    grid_latlon = np.stack(
        [np.repeat(lats, nlon), np.tile(lons, nlat)], -1
    )
    grid_xyz = latlon2xyz(grid_latlon)
    N = len(grid_xyz)

    # --- g2m: <=4-NN mesh vertices within 0.6 * max mesh edge length ---
    e_len = np.linalg.norm(
        verts[faces_l[:, [0, 0, 1]]] - verts[faces_l[:, [1, 2, 2]]], axis=-1
    ).max()
    tree = cKDTree(verts)
    dists, idx = tree.query(grid_xyz, k=4)
    keep = dists <= 0.6 * e_len
    g_src = np.repeat(np.arange(N), 4)[keep.reshape(-1)]
    g_dst = idx.reshape(-1)[keep.reshape(-1)]
    g2m_ef = edge_features_local(grid_xyz[g_src], verts[g_dst])
    g2m = GraphArrays(g_src.astype(np.int32), g_dst.astype(np.int32), g2m_ef, N, V)

    # --- m2g: 3 vertices of nearest face centroid ---
    ctree = cKDTree(ico[f"order_{mesh_level}_face_centroid"])
    _, fidx = ctree.query(grid_xyz, k=1)
    m_src = faces_l[fidx].reshape(-1)
    m_dst = np.repeat(np.arange(N), 3)
    m2g_ef = edge_features_local(verts[m_src], grid_xyz[m_dst])
    m2g = GraphArrays(m_src.astype(np.int32), m_dst.astype(np.int32), m2g_ef, V, N)

    return (
        mesh_graph, g2m, m2g,
        node_features(verts, unit=node_feat_unit), verts, grid_latlon,
    )
