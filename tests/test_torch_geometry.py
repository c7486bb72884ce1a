"""PyTorch port: the tet geometry primitives (``ops/geometry.py``), twins of
tests/test_geometry.py's ten tests, each against the JAX package's function
on the same float64 inputs within 1e-12 besides the hand values; and the
port's ``io.native.available`` against JAX's."""

from torch_port_common import CPU  # noqa: F401

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from cudaparticlesfoam_tpu.ops import geometry as jg  # noqa: E402
from cudaparticlesfoam_tpu_torch.ops import geometry as g  # noqa: E402

TOL = 1e-12
A, B, C, D = (torch.tensor(v, dtype=torch.float64) for v in
              ([0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]))


def same(got, jax_fn, *args):
    """``got`` (the port's) against the JAX function of the same inputs."""
    want = np.asarray(jax_fn(*(jnp.asarray(a.numpy()) if torch.is_tensor(a) else a
                               for a in args)))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    return got.numpy()


def test_det4_unit_tet():
    assert float(same(g.det4(A, B, C, D), jg.det4, A, B, C, D)) == pytest.approx(1.0)
    assert float(same(g.det4(B, A, C, D), jg.det4, B, A, C, D)) == pytest.approx(-1.0)


def test_tet_volume():
    assert float(same(g.tet_volume(A, B, C, D), jg.tet_volume, A, B, C, D)) == pytest.approx(
        1.0 / 6.0)


def test_bary_vertices():
    for i, v in enumerate([A, B, C, D]):
        w = same(g.tet_bary_coords(v, A, B, C, D), jg.tet_bary_coords, v, A, B, C, D)
        np.testing.assert_allclose(w, np.eye(4)[i], atol=1e-14)


def test_bary_centroid_and_outside():
    cen = (A + B + C + D) / 4.0
    w = same(g.tet_bary_coords(cen, A, B, C, D), jg.tet_bary_coords, cen, A, B, C, D)
    np.testing.assert_allclose(w, 0.25, atol=1e-14)
    p = torch.tensor([0.5, 0.5, 0.5], dtype=torch.float64)   # beyond the face opposite A
    w = same(g.tet_bary_coords(p, A, B, C, D), jg.tet_bary_coords, p, A, B, C, D)
    assert w[0] < 0 and (w[1:] > 0).all()
    assert w.sum() == pytest.approx(1.0)


def test_bary_from_tinv_matches_determinant_form():
    rng = np.random.default_rng(0)
    for _ in range(20):
        a, b, c, d = (torch.as_tensor(v) for v in rng.normal(size=(4, 3)))
        if abs(float(g.det4(a, b, c, d))) < 1e-3:
            continue
        p = torch.as_tensor(rng.normal(size=3))
        w_ref = g.tet_bary_coords(p, a, b, c, d).numpy()
        tinv = same(g.invert3x3(g.tet_edge_matrix(a, b, c, d)),
                    lambda *x: jg.invert3x3(jg.tet_edge_matrix(*x)), a, b, c, d)
        w_fast = same(g.bary_from_tinv(p, a, torch.as_tensor(tinv)), jg.bary_from_tinv, p, a,
                      torch.as_tensor(tinv))
        np.testing.assert_allclose(w_fast, w_ref, atol=1e-9)


def test_invert3x3():
    m = torch.as_tensor(np.random.default_rng(1).normal(size=(5, 3, 3)))
    inv = same(g.invert3x3(m), jg.invert3x3, m)
    np.testing.assert_allclose(np.einsum("bij,bjk->bik", inv, m.numpy()),
                               np.broadcast_to(np.eye(3), (5, 3, 3)), atol=1e-12)


def test_tri_normal_orientation():
    np.testing.assert_allclose(same(g.tri_normal(A, B, C), jg.tri_normal, A, B, C), [0, 0, 1],
                               atol=1e-15)
    np.testing.assert_allclose(same(g.tri_normal(A, C, B), jg.tri_normal, A, C, B), [0, 0, -1],
                               atol=1e-15)


def test_tri_bary():
    p = (A + B + C) / 3.0
    np.testing.assert_allclose(same(g.tri_bary_coords(p, A, B, C), jg.tri_bary_coords, p, A, B,
                                    C), 1 / 3, atol=1e-14)


def test_reflect_point_plane():
    n = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64)
    p = torch.tensor([0.3, 0.4, 1.5], dtype=torch.float64)
    out = same(g.reflect_point(p, n, 1.0), jg.reflect_point, p, n, 1.0)
    np.testing.assert_allclose(out, [0.3, 0.4, 0.5], atol=1e-15)
    out2 = same(g.reflect_point(p, -n, -1.0), jg.reflect_point, p, -n, -1.0)
    np.testing.assert_allclose(out2, out, atol=1e-15)


def test_reflect_vector():
    n = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64)
    v = torch.tensor([1.0, 2.0, -3.0], dtype=torch.float64)
    np.testing.assert_allclose(same(g.reflect_vector(v, n), jg.reflect_vector, v, n),
                               [1.0, 2.0, 3.0], atol=1e-15)


def test_batched_helpers_match_jax():
    """The helpers on [n, 3] batches (per particle) and dot3/cross3."""
    rng = np.random.default_rng(2)
    a, b, c, d, p = (torch.as_tensor(rng.normal(size=(64, 3))) for _ in range(5))
    same(g.dot3(a, b), jg.dot3, a, b)
    same(g.cross3(a, b), jg.cross3, a, b)
    same(g.tet_bary_coords(p, a, b, c, d), jg.tet_bary_coords, p, a, b, c, d)
    tinv = g.invert3x3(g.tet_edge_matrix(a, b, c, d))
    same(g.bary_from_tinv(p, a, tinv), jg.bary_from_tinv, p, a, tinv)
    same(g.tri_bary_coords(p, a, b, c), jg.tri_bary_coords, p, a, b, c)


def test_native_available_matches_jax():
    from cudaparticlesfoam_tpu.io import native as jnative
    from cudaparticlesfoam_tpu_torch.io import native

    assert native.available() == jnative.available()
