#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cudaparticlesfoam_tpu_torch) on one GPU.

    python3 chip_smoke.py               # the full check on cuda:0
    python3 chip_smoke.py --rehearse    # small sizes on the CPU, plain versions only

Phases, one line of numbers each, any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: compile csrc/*.cu with nvcc for sm_90a (seconds);
3. kernel vs plain, float32: box 16^3 (24,576 tets), 65,536 lanes, one
   cycle, for hops {1, 4} x escape faces {off, on} x reflect_wall {on, off}:
   stream_kernel against stream_plain, then rare_kernel against rare_plain
   on the same (m, pending); tet/active/pending identical, pos/vel within
   1e-5;
4. golden replay, float64, through the kernels: box_bary_adv and
   box_bary_brownian of tests/golden/particles_f64.npz from the recorded
   inputs in tests/golden/torch_port_box_inputs.npz; tet/active exact, pos
   within 1e-9;
5. the slice at the bench's north-star size: box 55^3 (998,250 tets) with
   the confined vortex, 1,000,000 owl-LCG seeds in [2.75, 52.25]^3,
   suggest_tuning(dt=0.05, D=1e-3); run_cycles 10 warm-up + 3 x 200 timed
   cycles (CUDA events), launch counts, domain checks, one extra cycle
   through kernel and plain, and each kernel's time against its plain
   version at this shape.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden", "particles_f64.npz")
INPUTS = os.path.join(HERE, "tests", "golden", "torch_port_box_inputs.npz")
POS_TOL_F32 = 1e-5       # kernel vs plain, float32 (both IEEE op for op)
POS_TOL_GOLDEN = 1e-9    # float64 replay against the CPU-made anchors


class Failure(Exception):
    pass


def need(cond, what):
    if not cond:
        raise Failure(what)


def log(*a):
    print(*a, flush=True)


class Timer:
    """Milliseconds of the work between start() and stop(): CUDA events on
    the card, the host clock after a sync on the CPU (rehearsal)."""

    def __init__(self, torch, device):
        self.torch, self.cuda = torch, device.type == "cuda"

    def start(self):
        if self.cuda:
            self.t0 = self.torch.cuda.Event(enable_timing=True)
            self.t1 = self.torch.cuda.Event(enable_timing=True)
            self.t0.record()
        else:
            self.h0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            self.t1.record()
            self.t1.synchronize()
            return self.t0.elapsed_time(self.t1)
        return (time.perf_counter() - self.h0) * 1e3


def stream_args(cfg, dt, dtype, fused):
    dt_t, sigma = fused.scalars(cfg, dt, dtype)
    return dict(dt=dt_t, sigma=sigma, use_adv=cfg.use_advection,
                use_brown=cfg.use_brownian,
                bounce_on=cfg.reflect_wall and cfg.inline_bounce,
                esc_on=cfg.escape_faces, n_hops=cfg.inline_hops)


def rare_args(cfg):
    return dict(max_hops=cfg.max_hops, max_bounces=cfg.max_bounces,
                reflect_wall=cfg.reflect_wall)


def compare(torch, a, b, pa=None, pb=None):
    """(discrete state identical, max |d| over pos/vel) of two megas."""
    same = bool(torch.equal(a[:, 6], b[:, 6]) and torch.equal(a[:, 7], b[:, 7]))
    if pa is not None:
        same = same and bool(torch.equal(pa, pb))
    return same, float((a[:, :6] - b[:, :6]).abs().max())


def box_payload(tmesh, nside, dtype, vel_fn):
    pts, tets, vv = tmesh.box_points_tets(nside, nside, nside)
    cen = pts[tets].mean(axis=1)
    payload = tmesh.from_arrays_host(pts, tets, tet_vel=vel_fn(cen), vert_vel=vv,
                                     dtype=dtype)
    ctr = payload["points"][payload["bd_tris"]].mean(axis=1)
    payload["bd_patch"] = (ctr[:, 0] > nside - 1e-6).astype(np.int32)
    return payload


def vortex(nside):
    """The bench's confined vortex (bench.py:53-60): tangential speed
    ~ r (1 - (r/R)^2), zero at the walls."""
    def fn(cen):
        r = cen[:, :2] - nside / 2.0
        r2 = (r * r).sum(axis=1) / (nside / 2.0) ** 2
        omega = (5.2 / nside) * np.maximum(1.0 - r2, 0.0)
        u = np.zeros_like(cen)
        u[:, 0] = -r[:, 1] * omega
        u[:, 1] = r[:, 0] * omega
        return u
    return fn


def phase_parity(torch, cpt, fused, fused_cuda, tmesh, convert, dev, nside, n, errs):
    """Phase 3: each kernel against its plain version on the same inputs."""
    def field(cen):   # outward plus a swirl: hops, walls and corner hits
        c = cen - nside / 2.0
        return c / nside * 2.0 + np.stack([-c[:, 1], c[:, 0], 0 * c[:, 2]], 1) / nside

    payload = box_payload(tmesh, nside, np.float32, field)
    base = convert.to_mesh(payload, dev)
    rng = np.random.default_rng(3)
    pos = torch.as_tensor(rng.uniform(0.05, nside - 0.05, (n, 3)), dtype=torch.float32,
                          device=dev)
    tet = cpt.locate_seeds(base, cpt.build_grid_locator(base), pos)
    vel = torch.as_tensor(rng.normal(size=(n, 3)), dtype=torch.float32, device=dev)
    act = torch.as_tensor(rng.uniform(size=n) > 0.02, device=dev)
    xi = torch.as_tensor(rng.standard_normal((n, 3)), dtype=torch.float32, device=dev)
    for hops in (1, 4):
        dt = 0.2 if hops == 1 else 0.9
        for esc in (False, True):
            mesh = tmesh.set_boundary_escape(base, [1] if esc else [])
            m0 = fused.pack_state(mesh, pos, vel, tet, act)
            for refl in (True, False):
                cfg = cpt.StepConfig(dt=dt, diffusion_coeff=5e-3, inline_hops=hops,
                                     escape_faces=esc, reflect_wall=refl)
                sa = stream_args(cfg, dt, torch.float32, fused)
                mk, mp = m0.clone(), m0.clone()
                pk = torch.empty(n, dtype=torch.uint8, device=dev)
                pp = torch.empty_like(pk)
                fused_cuda.stream_cycle(mesh.tet_row, mk, xi, pk, **sa)
                fused.stream_plain(mesh.tet_row, mp, xi, pp, **sa)
                same_s, err_s = compare(torch, mk, mp, pk, pp)
                rk, rp = mp.clone(), mp.clone()
                fused_cuda.rare_resolve(mesh.tet_row, rk, pp, mesh.bd_escape,
                                        **rare_args(cfg))
                fused.rare_plain(mesh.tet_row, rp, pp, mesh.bd_escape, **rare_args(cfg))
                same_r, err_r = compare(torch, rk, rp)
                npend = int(pp.sum())
                log(f"[parity] hops={hops} escape={int(esc)} reflect={int(refl)} "
                    f"pending={npend} stream_identical={int(same_s)} "
                    f"stream_max_abs_err={err_s:.3e} rare_identical={int(same_r)} "
                    f"rare_max_abs_err={err_r:.3e}")
                need(npend > 0, "parity case has no pending lanes")
                need(same_s and err_s <= POS_TOL_F32,
                     f"stream_kernel != stream_plain (hops={hops} esc={esc} refl={refl})")
                need(same_r and err_r <= POS_TOL_F32,
                     f"rare_kernel != rare_plain (hops={hops} esc={esc} refl={refl})")
                errs["stream"] = max(errs["stream"], err_s)
                errs["rare"] = max(errs["rare"], err_r)


def phase_golden(torch, cpt, convert, fused_cuda, dev):
    """Phase 4: replay the f64 golden box anchors through the kernels."""
    g = np.load(GOLDEN)
    fx = np.load(INPUTS)
    mesh = cpt.replace_velocity(cpt.box_mesh(6, 6, 6, dtype=np.float64, device=dev),
                                tet_vel=fx["tet_vel"])
    st = convert.to_state(fx["seed_pos"], fx["seed_tet"], dtype=np.float64, device=dev)
    for name, kw, noise in (
        ("bary_adv", dict(use_brownian=False), None),
        ("bary_brownian", dict(diffusion_coeff=1e-3),
         torch.as_tensor(fx["noise"], device=dev)),
    ):
        before = (fused_cuda.stream_cycle.launches, fused_cuda.rare_resolve.launches)
        fin = cpt.run_cycles(mesh, st, cpt.StepConfig(dt=0.08, **kw), 60, noise=noise)
        err = float(np.abs(fin.pos.cpu().numpy() - g[f"box_{name}_pos"]).max())
        tet_ok = bool((fin.tet_id.cpu().numpy() == g[f"box_{name}_tet"]).all())
        act_ok = bool((fin.active.cpu().numpy() == g[f"box_{name}_active"]).all())
        launched = (fused_cuda.stream_cycle.launches - before[0],
                    fused_cuda.rare_resolve.launches - before[1])
        log(f"[golden] {name} f64 max_abs_err={err:.3e} tet_exact={int(tet_ok)} "
            f"active_exact={int(act_ok)} launches={launched}")
        need(tet_ok and act_ok and err <= POS_TOL_GOLDEN, f"golden replay {name} failed")
        if dev.type == "cuda":
            need(launched == (60, 60), f"golden replay {name} did not run the kernels")


def time_calls(timer, fn, restore, reps):
    """Mean ms of fn() over reps, each after restore() (outside the timing)."""
    total = 0.0
    for _ in range(reps):
        restore()
        timer.start()
        fn()
        total += timer.stop()
    return total / reps


def phase_slice(torch, cpt, fused, fused_cuda, tmesh, dev, nside, n_particles,
                n_cycles, errs, gpu_line):
    """Phase 5: the north-star slice through run_cycles."""
    t0 = time.perf_counter()
    pts, tets, _ = tmesh.box_points_tets(nside, nside, nside)
    mesh = cpt.box_mesh(nside, nside, nside, device=dev)
    mesh = cpt.replace_velocity(mesh, tet_vel=vortex(nside)(pts[tets].mean(axis=1)))
    t_mesh = time.perf_counter() - t0
    lo, hi = 0.05 * nside, 0.95 * nside
    st = cpt.seed_in_box(n_particles, (lo,) * 3, (hi,) * 3, device=dev)
    st = dataclasses.replace(st, tet_id=cpt.locate_seeds(
        mesh, cpt.build_grid_locator(mesh), st.pos))
    n_in = int((st.tet_id >= 0).sum())
    cfg = cpt.suggest_tuning(mesh, cpt.StepConfig(dt=0.05, diffusion_coeff=1e-3),
                             n_particles=n_particles)
    t_setup = time.perf_counter() - t0
    log(f"[slice] tets={mesh.n_tets} particles={n_particles} seeds_in_domain={n_in} "
        f"inline_hops={cfg.inline_hops} inline_bounce={int(cfg.inline_bounce)} "
        f"mesh_build_s={t_mesh:.2f} setup_s={t_setup:.2f}")

    st = cpt.run_cycles(mesh, st, cfg, 10)            # warm-up
    timer = Timer(torch, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    fused_cuda.stream_cycle.launches = 0
    fused_cuda.rare_resolve.launches = 0
    runs = []
    for _ in range(3):
        timer.start()
        st = cpt.run_cycles(mesh, st, cfg, n_cycles)
        runs.append(timer.stop())
    launches = {"stream": fused_cuda.stream_cycle.launches,
                "rare": fused_cuda.rare_resolve.launches}
    ms_cycle = [r / n_cycles for r in runs]
    med = float(np.median(ms_cycle))
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    log(f"[slice] {gpu_line} | ms_per_cycle={['%.4f' % x for x in ms_cycle]} "
        f"median={med:.4f} particle_steps_per_s={n_particles / (med * 1e-3):.4e} "
        f"max_memory_allocated={peak} launches={launches}")
    if dev.type == "cuda":
        need(launches == {"stream": 3 * n_cycles, "rare": 3 * n_cycles},
             f"launch counts {launches} != {3 * n_cycles} per kernel")

    d = cpt.diagnostics(st)
    active = int(d["active"])
    bad = int((st.active & (st.tet_id < 0)).sum())
    blo, bhi = mesh.bounds_lo.to(st.dtype), mesh.bounds_hi.to(st.dtype)
    outside = int(((st.pos < blo - 1e-3) | (st.pos > bhi + 1e-3)).any(dim=1).sum())
    log(f"[slice] active={active} seeds_in_domain={n_in} active_with_negative_tet={bad} "
        f"outside_bounds={outside} kinetic_energy={float(d['kinetic_energy']):.6e}")
    need(active == n_in and bad == 0 and outside == 0, "slice left the domain")
    need(bool(torch.isfinite(st.pos).all()), "non-finite positions")

    # one extra cycle through kernel and plain on the same inputs, and each
    # kernel's time against its plain version at this shape
    m0 = fused.pack_state(mesh, st.pos, st.vel, st.tet_id, st.active)
    xi = fused._brownian_noise(st.seed, st.step, n_particles, m0.dtype, dev)
    sa = stream_args(cfg, cfg.dt, m0.dtype, fused)
    mk, mp = m0.clone(), m0.clone()
    pk = torch.empty(n_particles, dtype=torch.uint8, device=dev)
    pp = torch.empty_like(pk)
    fused_cuda.stream_cycle(mesh.tet_row, mk, xi, pk, **sa)
    fused.stream_plain(mesh.tet_row, mp, xi, pp, **sa)
    same_s, err_s = compare(torch, mk, mp, pk, pp)
    m1, p1 = mp.clone(), pp.clone()
    fused_cuda.rare_resolve(mesh.tet_row, mk, pk, mesh.bd_escape, **rare_args(cfg))
    fused.rare_plain(mesh.tet_row, mp, pp, mesh.bd_escape, **rare_args(cfg))
    same, err = compare(torch, mk, mp)
    log(f"[slice] extra cycle kernel vs plain: pending={int(p1.sum())} "
        f"stream_identical={int(same_s)} stream_max_abs_err={err_s:.3e} "
        f"cycle_identical={int(same)} cycle_max_abs_err={err:.3e}")
    need(same_s and same and max(err, err_s) <= POS_TOL_F32, "extra cycle kernel != plain")
    errs["stream"] = max(errs["stream"], err_s)
    errs["rare"] = max(errs["rare"], err)

    work, pend = m0.clone(), pk.clone()

    def restore_stream():
        work.copy_(m0)

    def restore_rare():
        work.copy_(m1)
        pend.copy_(p1)

    times = {}
    for key, fn, plain, restore in (
        ("stream", lambda: fused_cuda.stream_cycle(mesh.tet_row, work, xi, pend, **sa),
         lambda: fused.stream_plain(mesh.tet_row, work, xi, pend, **sa), restore_stream),
        ("rare", lambda: fused_cuda.rare_resolve(mesh.tet_row, work, pend, mesh.bd_escape,
                                                 **rare_args(cfg)),
         lambda: fused.rare_plain(mesh.tet_row, work, pend, mesh.bd_escape,
                                  **rare_args(cfg)), restore_rare),
    ):
        fn(), plain()    # warm-up
        # alternate plain, kernel, kernel, plain
        p_a = time_calls(timer, plain, restore, 5)
        k_a = time_calls(timer, fn, restore, 20)
        k_b = time_calls(timer, fn, restore, 20)
        p_b = time_calls(timer, plain, restore, 5)
        times[key] = ((k_a + k_b) / 2, (p_a + p_b) / 2)
        log(f"[slice] {gpu_line} | {key}_kernel_ms={times[key][0]:.4f} "
            f"({k_a:.4f}, {k_b:.4f}) {key}_plain_ms={times[key][1]:.4f} "
            f"({p_a:.4f}, {p_b:.4f}) lanes={n_particles}")
    return launches, times, med


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="run every phase at small sizes on the CPU (plain versions "
                         "only); prints no device result and exits 2")
    args = ap.parse_args()

    import torch

    sys.path.insert(0, HERE)
    import cudaparticlesfoam_tpu_torch as cpt
    from cudaparticlesfoam_tpu_torch import convert
    from cudaparticlesfoam_tpu_torch import mesh as tmesh
    from cudaparticlesfoam_tpu_torch.ops import _build, fused, fused_cuda

    need("jax" not in sys.modules, "the port imported jax")
    need(os.path.exists(GOLDEN) and os.path.exists(INPUTS), "golden fixtures missing")

    if args.rehearse:
        dev = torch.device("cpu")
        sizes = dict(parity=(6, 4096), slice=(12, 20_000, 5))
        gpu_line = "cpu rehearsal"
        kind = "cpu"
    else:
        if not torch.cuda.is_available():
            print("FAIL: torch.cuda.is_available() is False", file=sys.stderr)
            return 1
        dev = torch.device("cuda", 0)
        sizes = dict(parity=(16, 65_536), slice=(55, 1_000_000, 200))
        kind = torch.cuda.get_device_name(0)
        gpu_line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
        log(f"[device] torch={torch.__version__} cuda={torch.version.cuda} "
            f"name={kind} count={torch.cuda.device_count()}")
        log(gpu_line)
        t0 = time.perf_counter()
        secs = _build.build_seconds()
        log(f"[build] nvcc sm_90a --fmad=false build+load_s={secs:.2f} "
            f"(phase {time.perf_counter() - t0:.2f} s)")

    errs = {"stream": 0.0, "rare": 0.0}
    nside, n = sizes["parity"]
    phase_parity(torch, cpt, fused, fused_cuda, tmesh, convert, dev, nside, n, errs)
    phase_golden(torch, cpt, convert, fused_cuda, dev)
    launches, times, _ = phase_slice(torch, cpt, fused, fused_cuda, tmesh, dev,
                                     *sizes["slice"], errs, gpu_line)

    table = {"kernels": [
        {"name": "stream_kernel", "route": "cuda",
         "source": "cudaparticlesfoam_tpu_torch/csrc/stream.cu",
         "replaces": "cudaparticlesfoam_tpu/ops/fused_pallas.py:334",
         "launches": launches["stream"], "max_abs_err": errs["stream"],
         "ms": times["stream"][0], "plain_ms": times["stream"][1]},
        {"name": "rare_kernel", "route": "cuda",
         "source": "cudaparticlesfoam_tpu_torch/csrc/rare.cu",
         "replaces": "cudaparticlesfoam_tpu/ops/fused.py:921",
         "launches": launches["rare"], "max_abs_err": errs["rare"],
         "ms": times["rare"][0], "plain_ms": times["rare"][1]},
    ]}
    log(gpu_line)
    log(json.dumps(table))
    if args.rehearse:
        log("rehearsal done: plain versions on the CPU, no device result")
        return 2
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failure as exc:
        print(f"FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
