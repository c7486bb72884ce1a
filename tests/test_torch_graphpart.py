"""PyTorch port: the decomposition host code (``parallel/graphpart.py``,
``flowshard.rcb_map`` and ``read_decompose_par``) pinned to the JAX
package's, and the twins of tests/test_flowshard.py's partitioner tests.

The partitioner is the port's own numpy copy (the port never imports the
JAX package), so every map must equal JAX's cell for cell: the graph
bisection on pitzDaily and on the duct, RCB, and the method a
decomposeParDict selects."""

from torch_port_common import PITZ, flowshard_duct

import os  # noqa: E402
import tempfile  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from cudaparticlesfoam_tpu.parallel import flowshard as jfs  # noqa: E402
from cudaparticlesfoam_tpu.parallel import graphpart as jgp  # noqa: E402
from cudaparticlesfoam_tpu_torch.io import blockmesh  # noqa: E402
from cudaparticlesfoam_tpu_torch.models import fv  # noqa: E402
from cudaparticlesfoam_tpu_torch.parallel import flowshard, graphpart  # noqa: E402


def duct_pm(nx=24, ny=4, nz=4):
    return blockmesh.generate(flowshard_duct(tempfile.mkdtemp(), nx, ny, nz))


@pytest.fixture(scope="module")
def pitz():
    """pitzDaily's mesh and its adjacency (owner, neighbour, cell centres)."""
    pm = blockmesh.generate(os.path.join(PITZ, "system", "blockMeshDict"))
    m = fv.fv_mesh(pm, dtype="float64", device="cpu")
    return pm, fv.host(m.own_i), fv.host(m.neighbour), fv.host(m.cc)


@pytest.mark.parametrize("k", [2, 3, 4, 8])
def test_graph_map_and_edge_cut_match_jax(pitz, k):
    pm, own, nei, cc = pitz
    got = graphpart.graph_map(pm.n_cells, own, nei, k, coords=cc)
    want = jgp.graph_map(pm.n_cells, own, nei, k, coords=cc)
    np.testing.assert_array_equal(got, want)
    assert graphpart.edge_cut(pm.n_cells, own, nei, got) == jgp.edge_cut(pm.n_cells, own,
                                                                          nei, want)


@pytest.mark.parametrize("seed", [0, 7])
def test_partition_graph_without_coords_matches_jax(seed):
    """The duct's graph without the geometric candidate (the bare
    multilevel bisection, its rng draws) for two seeds."""
    pm = duct_pm()
    m = fv.fv_mesh(pm, dtype="float64", device="cpu")
    own, nei = fv.host(m.own_i), fv.host(m.neighbour)
    xadj, adj, w = graphpart.csr_from_faces(pm.n_cells, own, nei)
    jx = jgp.csr_from_faces(pm.n_cells, own, nei)
    for a, b in zip((xadj, adj, w), jx):
        np.testing.assert_array_equal(a, b)
    got = graphpart.partition_graph(xadj, adj, w, 5, seed=seed)
    np.testing.assert_array_equal(got, jgp.partition_graph(*jx, 5, seed=seed))


@pytest.mark.parametrize("k", [3, 6, 8])
def test_rcb_map_matches_jax(pitz, k):
    _, _, _, cc = pitz
    np.testing.assert_array_equal(flowshard.rcb_map(cc, k), jfs.rcb_map(cc, k))


DICTS = {
    "simple": "numberOfSubdomains 4;\nmethod simple;\ncoeffs { n (4 1 1); }\n",
    "hierarchical": "method hierarchical;\nhierarchicalCoeffs { n (2 2 1); order xyz; }\n",
    "mismatch": "numberOfSubdomains 4;\nmethod simple;\ncoeffs { n (2 1 1); }\n",
    "subdomains": "numberOfSubdomains 8;\nmethod simple;\ncoeffs { n (4 1 1); }\n",
    "rcb": "method rcb;\n",
    "metis": "numberOfSubdomains 4;\nmethod metis;\n",
    "manual": "method manual;\n",
}


@pytest.mark.parametrize("name", sorted(DICTS))
def test_read_decompose_par_matches_jax(tmp_path, name):
    (tmp_path / "system").mkdir()
    (tmp_path / "system" / "decomposeParDict").write_text(
        "FoamFile { version 2.0; format ascii; object decomposeParDict; }\n" + DICTS[name])
    got, want = [], []
    out = flowshard.read_decompose_par(str(tmp_path), 4, log=got.append)
    assert out == jfs.read_decompose_par(str(tmp_path), 4, log=want.append)
    assert got == want


# ---------------------------------------------------------------- twins


def test_rcb_map_balances_cells():
    """Twin of tests/test_flowshard.py::test_rcb_map_balances_cells."""
    pm = duct_pm()
    m = fv.fv_mesh(pm, dtype="float64", device="cpu")
    dev = flowshard.rcb_map(fv.host(m.cc), 6)      # non-power-of-two too
    counts = np.bincount(dev, minlength=6)
    assert counts.sum() == m.n_cells
    assert counts.max() - counts.min() <= 1


def test_graph_partition_beats_rcb_pitzdaily(pitz):
    """Twin of tests/test_flowshard.py::test_graph_partition_beats_rcb_pitzdaily:
    the graph partitioner's edge-cut is below RCB's, balance bounded."""
    pm, own, nei, cc = pitz
    for k in (4, 8):
        gp = graphpart.graph_map(pm.n_cells, own, nei, k, coords=cc)
        rcb = flowshard.rcb_map(cc, k)
        cut_g = graphpart.edge_cut(pm.n_cells, own, nei, gp)
        cut_r = graphpart.edge_cut(pm.n_cells, own, nei, rcb)
        assert cut_g < cut_r, (k, cut_g, cut_r)
        counts = np.bincount(gp, minlength=k)
        assert counts.sum() == pm.n_cells
        assert counts.max() <= pm.n_cells / k * graphpart.UB ** 3 + 1


def test_read_decompose_par_scotch_routes_graph(tmp_path):
    """Twin of tests/test_flowshard.py::test_read_decompose_par_scotch_routes_graph."""
    (tmp_path / "system").mkdir()
    (tmp_path / "system" / "decomposeParDict").write_text(
        "FoamFile { version 2.0; format ascii; object decomposeParDict; }\n"
        "numberOfSubdomains 8;\nmethod scotch;\n")
    msgs = []
    assert flowshard.read_decompose_par(str(tmp_path), 8, log=msgs.append) == "graph"
    assert any("graph bisection" in m for m in msgs)
