"""The port's graph construction (`dlwpbench_tpu_torch/grids/{icosphere,
mesh_graph}.py`, `models/mgn.py::build_grid_graph`) against the JAX
package's: every array equal bit for bit (indices, edge and node features,
positions, the grid's lat-lon), in the same process and so under the same
scipy (the Delaunay graph is reproducible per scipy build only)."""

import numpy as np
import pytest

from dlwpbench_tpu.grids import icosphere as jico
from dlwpbench_tpu.grids import mesh_graph as jmg
from dlwpbench_tpu.models import mgn as jmgn
from dlwpbench_tpu_torch.grids import icosphere as tico
from dlwpbench_tpu_torch.grids import mesh_graph as tmg
from dlwpbench_tpu_torch.models import mgn as tmgn


def assert_same(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("order, nv", [(0, 12), (1, 42), (2, 162), (3, 642)])
def test_icosphere_counts_and_prefix(order, nv):
    """Vertex and face counts, unit vertices, order k a prefix of k+1, and
    every table equal to JAX's."""
    ico = tico.icospheres(order + 1)
    assert ico[f"order_{order}_vertices"].shape == (nv, 3)
    assert ico[f"order_{order}_faces"].shape == (20 * 4**order, 3)
    np.testing.assert_allclose(np.linalg.norm(ico[f"order_{order}_vertices"], axis=1), 1.0,
                               atol=1e-12)
    assert_same(ico[f"order_{order + 1}_vertices"][:nv], ico[f"order_{order}_vertices"],
                "prefix")
    want = jico.icospheres(order + 1)
    assert ico.keys() == want.keys()
    for k in want:
        assert_same(ico[k], want[k], k)


@pytest.mark.parametrize("unit", ["rad", "deg_quirk"])
@pytest.mark.parametrize("convention", ["cell_centers", "pole_inclusive"])
@pytest.mark.parametrize("level, nlat, nlon", [(1, 8, 16), (2, 8, 16), (1, 16, 32),
                                               (2, 16, 32)])
def test_graphcast_graphs_match_jax(level, nlat, nlon, convention, unit):
    got = tmg.build_graphcast_graphs(nlat, nlon, level, grid_convention=convention,
                                     node_feat_unit=unit)
    want = jmg.build_graphcast_graphs(nlat, nlon, level, grid_convention=convention,
                                      node_feat_unit=unit)
    for name, g, w in zip(("multimesh", "g2m", "m2g"), got[:3], want[:3]):
        for field in ("src", "dst", "edge_feat"):
            assert_same(getattr(g, field), getattr(w, field), f"{name}.{field}")
        assert (g.n_src, g.n_dst) == (w.n_src, w.n_dst), name
    for name, g, w in zip(("mesh_node_feat", "mesh_pos", "grid_latlon"), got[3:], want[3:]):
        assert_same(g, w, name)
    mesh, g2m, m2g = got[:3]
    assert m2g.src.shape[0] == 3 * nlat * nlon and g2m.n_dst == mesh.n_src


def test_graph_helpers_raise_like_jax():
    with pytest.raises(ValueError, match="grid_convention"):
        tmg.build_graphcast_graphs(8, 16, 1, grid_convention="corners")
    with pytest.raises(ValueError, match="unit"):
        tmg.node_features(np.eye(3), unit="deg")


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("graph_type", ["grid_2d", "grid_2d_8stencil", "delaunay"])
@pytest.mark.parametrize("H, W", [(8, 16), (5, 7)])
def test_grid_graph_matches_jax(H, W, graph_type, periodic):
    got = tmgn.build_grid_graph(H, W, graph_type, periodic)
    want = jmgn.build_grid_graph(H, W, graph_type, periodic)
    for name, g, w in zip(("src", "dst", "edge_feat"), got, want):
        assert_same(g, w, name)


@pytest.mark.parametrize("graph_type", ["grid_2d", "grid_2d_8stencil"])
def test_stencil_edge_feats_match_jax(graph_type):
    assert_same(tmgn.stencil_edge_feats(graph_type), jmgn.stencil_edge_feats(graph_type),
                graph_type)
    assert tmgn.STENCIL_DIRS == jmgn.STENCIL_DIRS
