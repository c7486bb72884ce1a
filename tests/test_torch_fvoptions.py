"""PyTorch port: momentum fvOptions (``models/fvoptions.py``) — the twins of
tests/test_fvoptions.py's single-device tests on the CPU (the parser, the
meanVelocityForce channel, and the semiImplicitSource Su and Su + Sp
channels against their analytic profiles), and the sources both packages
read from one case compared field for field.  The sharded test has no
twin: the sharded flow solve is item 13c."""

from torch_port_common import CPU, FVO_CHANNEL_BMD, write_files

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from cudaparticlesfoam_tpu_torch.io import blockmesh  # noqa: E402
from cudaparticlesfoam_tpu_torch.models import fv, fvoptions  # noqa: E402
from cudaparticlesfoam_tpu_torch.models.pimple import PimpleConfig, pimple_step  # noqa: E402
from cudaparticlesfoam_tpu_torch.models.simple import FlowState  # noqa: E402

H = 0.1
NU = 0.01
UBAR = 1.0
F64 = torch.float64


@pytest.fixture(scope="module")
def channel_pm(tmp_path_factory):
    d = tmp_path_factory.mktemp("fvo_chan")
    (d / "blockMeshDict").write_text(FVO_CHANNEL_BMD)
    return blockmesh.generate(str(d / "blockMeshDict"))


def _force_driven_setup(pm):
    """Channel with zeroGradient U and fixed equal p at both ends: the only
    thing that can drive flow is a momentum source."""
    m = fv.fv_mesh(pm, dtype=F64, device=CPU)
    u_bcs = fv.make_bcs(m, {"walls": ("noSlip", 0.0)}, 3, default="zeroGradient")
    p_bcs = fv.make_bcs(m, {"inlet": ("fixedValue", 0.0), "outlet": ("fixedValue", 0.0)}, 1)
    u0 = torch.zeros((m.n_cells, 3), dtype=F64)
    st = FlowState(u=u0, p=torch.zeros(m.n_cells, dtype=F64), flux=fv.flux_of(m, u0, u_bcs))
    return m, st, u_bcs, p_bcs


def _inert_fvo(m):
    z = torch.zeros((), dtype=F64)
    return fvoptions.FvOptions(
        su=torch.zeros((m.n_cells, 3), dtype=F64), sp=torch.zeros(m.n_cells, dtype=F64),
        mvf_dir=torch.zeros(3, dtype=F64), mvf_mask=torch.zeros(m.n_cells, dtype=F64),
        mvf_mag=z, mvf_relax=z + 1.0, grad_p=z, dgrad=z, has_mvf=False)


def _run(m, st, u_bcs, p_bcs, fvo, n_steps, dt=0.02):
    cfg = PimpleConfig(nu=NU, n_correctors=2, n_jacobi=10, p_tol=1e-10, p_max_iter=500)
    for _ in range(n_steps):
        st, res = pimple_step(m, st, u_bcs, p_bcs, cfg, dt, fvo=fvo)
        fvo = dataclasses.replace(fvo, grad_p=res["fvo_grad_p"], dgrad=res["fvo_dgrad"])
    return st, fvo


def _mid_profile(m, st):
    u, cc = st.u.numpy(), m.cc.numpy()
    sel = np.abs(cc[:, 0] - 0.5) < 0.05
    return u[sel, 0], cc[sel, 1]


FVO_TEXT = ("FoamFile { version 2.0; format ascii; object fvOptions; }\n"
            "momentumSource {\n type meanVelocityForce;\n meanVelocityForceCoeffs {\n"
            "  selectionMode all;\n  fields (U);\n  Ubar (2 0 0);\n }\n}\n"
            "damping {\n type vectorSemiImplicitSource;\n volumeMode specific;\n"
            " selectionMode all;\n injectionRateSuSp {\n  U ((0.5 0 0) -2.0);\n }\n}\n")


def test_parse_fv_options(channel_pm, tmp_path):
    write_files(tmp_path, {"system/fvOptions": FVO_TEXT, "constant/.keep": ""})
    m = fv.fv_mesh(channel_pm, dtype=F64, device=CPU)
    fvo = fvoptions.from_case(str(tmp_path), m)
    assert fvo is not None and fvo.has_mvf
    assert float(fvo.mvf_mag) == 2.0
    np.testing.assert_allclose(fvo.mvf_dir.numpy(), [1.0, 0.0, 0.0])
    np.testing.assert_allclose(fvo.su.numpy()[:, 0], 0.5)
    np.testing.assert_allclose(fvo.sp.numpy(), -2.0)
    assert fvo.mvf_mask.numpy().min() == 1.0
    # no momentum entries -> None
    (tmp_path / "system" / "fvOptions").write_text(
        "FoamFile { version 2.0; format ascii; object fvOptions; }\n")
    assert fvoptions.from_case(str(tmp_path), m) is None
    # unknown type is a loud error, not a silent drop
    (tmp_path / "system" / "fvOptions").write_text(
        "FoamFile { version 2.0; format ascii; object fvOptions; }\n"
        "rot { type solidificationMeltingSource; }\n")
    with pytest.raises(ValueError, match="not supported"):
        fvoptions.from_case(str(tmp_path), m)


def test_mean_velocity_force_channel(channel_pm):
    """meanVelocityForce drives a closed-loop Poiseuille flow: the zone mean
    velocity settles on |Ubar| and the accumulated gradient on the analytic
    12 nu Ubar / H^2."""
    m, st, u_bcs, p_bcs = _force_driven_setup(channel_pm)
    fvo = dataclasses.replace(
        _inert_fvo(m), mvf_dir=torch.tensor([1.0, 0.0, 0.0], dtype=F64),
        mvf_mask=torch.ones(m.n_cells, dtype=F64), mvf_mag=torch.tensor(UBAR, dtype=F64),
        has_mvf=True)
    st, fvo = _run(m, st, u_bcs, p_bcs, fvo, 150)
    vol = m.vol.numpy()
    mean_u = (vol * st.u.numpy()[:, 0]).sum() / vol.sum()
    assert abs(mean_u - UBAR) < 1e-6, mean_u
    ux, y = _mid_profile(m, st)
    ana = 6.0 * UBAR * (y / H) * (1.0 - y / H)
    assert np.abs(ux - ana).max() / (1.5 * UBAR) < 0.03
    g_ana = 12.0 * NU * UBAR / H**2
    assert abs(float(fvo.grad_p) - g_ana) / g_ana < 0.03


def test_semi_implicit_source_su_channel(channel_pm):
    """Open-loop uniform Su force reproduces the same Poiseuille flow the
    analytic gradient would."""
    m, st, u_bcs, p_bcs = _force_driven_setup(channel_pm)
    g = 12.0 * NU * UBAR / H**2
    fvo = dataclasses.replace(_inert_fvo(m),
                              su=torch.tensor([[g, 0.0, 0.0]], dtype=F64).repeat(m.n_cells, 1))
    st, _ = _run(m, st, u_bcs, p_bcs, fvo, 150)
    ux, y = _mid_profile(m, st)
    ana = 6.0 * UBAR * (y / H) * (1.0 - y / H)
    assert np.abs(ux - ana).max() / (1.5 * UBAR) < 0.03


def test_semi_implicit_source_sp_damping(channel_pm):
    """Su + implicit Sp damping: steady nu u'' + Su + Sp u = 0 has the exact
    solution (Su/c)(1 - cosh(k(y-H/2))/cosh(kH/2)), k=sqrt(c/nu), c=-Sp."""
    m, st, u_bcs, p_bcs = _force_driven_setup(channel_pm)
    su, c = 10.0, 50.0
    fvo = dataclasses.replace(_inert_fvo(m),
                              su=torch.tensor([[su, 0.0, 0.0]], dtype=F64).repeat(m.n_cells, 1),
                              sp=torch.full((m.n_cells,), -c, dtype=F64))
    st, _ = _run(m, st, u_bcs, p_bcs, fvo, 200)
    ux, y = _mid_profile(m, st)
    k = np.sqrt(c / NU)
    ana = (su / c) * (1.0 - np.cosh(k * (y - H / 2)) / np.cosh(k * H / 2))
    assert np.abs(ux - ana).max() / ana.max() < 0.03


def test_fv_options_match_jax(channel_pm, tmp_path):
    """The sources both packages read from one case, field for field."""
    from cudaparticlesfoam_tpu.io import blockmesh as jblockmesh
    from cudaparticlesfoam_tpu.models import fv as jfv
    from cudaparticlesfoam_tpu.models import fvoptions as jfvo

    write_files(tmp_path, {"system/fvOptions": FVO_TEXT, "constant/.keep": "",
                           "system/blockMeshDict": FVO_CHANNEL_BMD})
    jpm = jblockmesh.generate(str(tmp_path / "system" / "blockMeshDict"))
    want = jfvo.from_case(str(tmp_path), jfv.fv_mesh(jpm, dtype=np.float64))
    got = fvoptions.from_case(str(tmp_path), fv.fv_mesh(channel_pm, dtype=F64, device=CPU))
    assert got.has_mvf == want.has_mvf
    for f in dataclasses.fields(got):
        if f.name != "has_mvf":
            np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                          np.asarray(getattr(want, f.name)), f.name)
