"""Wrappers of the hand-written CUDA kernels (the port's counterpart of
``cudaparticlesfoam_tpu/ops/fused_pallas.py``).

* :func:`stream_cycle` -> ``stream_kernel`` (``csrc/stream.cu``): the
  TPU stream kernels A / hop H / B / B2 in their packed and transposed
  variants (``fused_pallas.py`` kernels 1-9), fused into one per-lane
  kernel that loads neighbour rows itself; with ``rk4`` its RK4
  instantiation, whose stage walks replace the XLA stage velocity
  (``fused._stage_velocity`` and the RK4 branch of
  ``_mega_cycle_aligned``).
* :func:`rare_resolve` -> ``rare_kernel`` (``csrc/rare.cu``): the XLA rare
  stage (``fused._rare_stage(_packed)`` with ``_walk_mega`` and
  ``_reflect_mega``), in one wave of resident blocks that compact their
  own pending lanes (``csrc/pending.cuh``, as ``convex_rare_kernel``).
  Both take the layout ``ly``: ``LAYOUT_TET`` (TetVelocity) or
  ``LAYOUT_PK`` (VertexVelocity: the TPU kernels' ``ly=LAYOUT_PK``
  instantiations), each its own instantiation of the kernel.  With
  ``remote=(R0, per)`` :func:`rare_resolve` launches
  ``rare_kernel<T, L, kRemote>``, the rare stage of a partitioned shard
  (``parallel/partition.py``: the XLA rare stage with
  ``_make_run_lanes_remote``), which pauses lanes at tets of other shards.
* :func:`convex_stream_cycle` -> ``convex_stream_kernel``
  (``csrc/convex_stream.cu``): the convex stream kernels CA / CB
  (``_kernel_ca_packed``, ``_kernel_ca_packed_k``, ``_kernel_cb_packed``)
  with the cx-row gather between them.
* :func:`convex_rare_resolve` -> ``convex_rare_kernel``
  (``csrc/convex_rare.cu``): the XLA convex rare stage
  (``fused_convex._rare_stage(_packed)`` with ``_make_run_lanes``).
* :func:`hop_admit` -> ``hop_admit_kernel`` (``csrc/hop_admit.cu``): the
  admission of the block-compacted hop gather (``hop_compact=4``;
  ``_compact_hop_rows`` and ``_kernel_src_c``).  It sits between the flag
  stage (:func:`stream_crossers`, :func:`convex_stream_crossers`,
  :func:`macro_crossers`: the stream kernels' crossing flags) and the
  apply stage (the stream wrappers with ``admit``, ``_kernel_b_packed_c``
  and ``_kernel_cb_packed_c``).
* :func:`macro_stream` -> ``macro_stream_kernel`` (``csrc/macro.cu``): one
  trip of a macro cycle (``macro_cycles`` = k), the TPU's macro kernels
  ``_kernel_ak_packed(_k)``, ``_kernel_bk_packed`` and
  ``_kernel_bk_packed_c``.

Brownian noise: with ``noise_key`` (the 4 words of ``fused.philox_key``)
a stream kernel on CUDA draws the JAX "rbg" Philox stream itself
(``csrc/philox.cuh``, the TPU's in-kernel noise ``_kernel_*_k``); on the
CPU the wrapper draws the same stream with ``fused.philox_normals``.
Without it the kernel reads ``xi`` [n, 3] ([k, n, 3] for a macro trip).

A wrapper given CPU tensors runs the plain version from ``ops/fused.py``;
given CUDA tensors it launches the kernel on the current stream, or
raises; the launch runs on the tensors' own card, which must be the
current device (``torch.cuda.device``).  Each wrapper counts its kernel
launches in ``.launches``.  A
launch costs the host about as much as a short kernel costs the card, so
the checks take their passing case first and nothing is looked up twice.
"""

from __future__ import annotations

import functools

import torch

from . import _build
from . import fused_convex
from .fused import (LAYOUT_PK, LAYOUT_TET, hop_admit_plain, macro_stream_plain,
                    philox_normals, rare_plain, stream_plain)

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check(name, t, *, dtype, shape, device):
    # the passing case first, in one expression: this runs several times per
    # launch, and the host's cost per launch bounds the short kernels' paths
    if (isinstance(t, torch.Tensor) and t.dtype == dtype and t.device == device
            and t.shape == shape and t.is_contiguous()):
        return
    if not torch.is_tensor(t):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_tab_m(tab, m, width=LAYOUT_TET.width, row_w=LAYOUT_TET.row_w):
    if m.dtype not in _SUFFIX:
        raise TypeError(f"m must be float32 or float64, got {m.dtype}")
    if m.dim() != 2:
        raise ValueError(f"m must be [n, {width}], got {tuple(m.shape)}")
    n, dev = m.shape[0], m.device
    _check("m", m, dtype=m.dtype, shape=(n, width), device=dev)
    if tab.dim() != 2:
        raise ValueError(f"tab must be [nt, {row_w}], got {tuple(tab.shape)}")
    _check("tab", tab, dtype=m.dtype, shape=(tab.shape[0], row_w), device=dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    # the kernels move mega and table rows as 16 B vectors
    for name, t in (("m", m), ("tab", tab)):
        if dev.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    return n, dev


def _noise_args(xi, n, m, use_brown, noise_key, k=None):
    """(xi for the plain version, xi pointer, mode, 4 key words) of a
    stream call (with ``k``, of a macro trip: xi [k, n, 3], and sub-step j
    draws with the key's last word + j); mode 1 = in-kernel Philox."""
    if not use_brown:
        return None, None, 0, (0, 0, 0, 0)
    if noise_key is None:
        shape = (n, 3) if k is None else (k, n, 3)
        _check("xi", xi, dtype=m.dtype, shape=shape, device=m.device)
        return xi, xi.data_ptr(), 0, (0, 0, 0, 0)
    if xi is not None:
        raise ValueError("pass xi or noise_key, not both")
    key = tuple(int(w) for w in noise_key)
    if len(key) != 4 or not all(0 <= w < (1 << 32) for w in key):
        raise ValueError(f"noise_key must be 4 uint32 words, got {noise_key!r}")
    if m.device.type == "cpu":
        if k is None:
            return philox_normals(key, n, m.dtype, m.device), None, 1, key
        return torch.stack([philox_normals(key[:3] + ((key[3] + j) & 0xFFFFFFFF,), n, m.dtype,
                                           m.device) for j in range(k)]), None, 1, key
    return None, None, 1, key


def _flags(name, t, n, dev):
    """Check an optional [n] uint8 flag array; its pointer (None if absent)."""
    if t is None:
        return None
    _check(name, t, dtype=torch.uint8, shape=(n,), device=dev)
    return t.data_ptr()


def _check_flag_alignment(**flags):
    """hop_admit_kernel, and macro_stream_kernel's whole pass, move a block's
    flag bytes as 16 B vectors."""
    for name, t in flags.items():
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def _check_hops(n_hops):
    if not 0 <= int(n_hops) <= 8:
        raise ValueError(f"n_hops must be in 0..8, got {n_hops}")


# the pass of a stream kernel (csrc/stream.cuh: StreamPass)
PASS_WHOLE, PASS_CROSSERS, PASS_ADMITTED = 0, 1, 2
ADMIT_TILE = 8192       # lanes per block of hop_admit_kernel (ADMIT_LANES)


# PyTorch's own fast getter of the current stream's handle (what its compiled
# kernels' launchers call); the public route builds a Stream object per call
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream_ptr(dev) -> int:
    """The current CUDA stream of ``dev`` as an integer handle.  ``dev``
    must be the current device: the kernels launch on the current device,
    so tensors on another card would be read from the wrong one (the
    caller selects it with ``torch.cuda.device(dev)``)."""
    cur = torch.cuda.current_device()
    if dev.index is not None and dev.index != cur:
        raise ValueError(f"tensors on {dev}, but the current device is cuda:{cur}: launch "
                         f"under torch.cuda.device({dev})")
    if _RAW_STREAM is not None:
        return _RAW_STREAM(cur)
    return torch.cuda.current_stream(dev).cuda_stream


@functools.lru_cache(maxsize=None)
def _entry(name, dtype=None):
    """The C entry point ``cpf_<name>[_f32|_f64]`` of the kernel library."""
    suffix = f"_{_SUFFIX[dtype]}" if dtype is not None else ""
    return getattr(_build.library(), f"cpf_{name}{suffix}")


def _raise_on(err, what):
    if err:
        _build.check(_build.library(), err, what)


def _layout_entry(name, ly):
    """Name of the C entry of ``name``'s instantiation for layout ``ly``."""
    if ly is LAYOUT_TET:
        return name
    if ly is LAYOUT_PK:
        return name + "_pk"
    raise ValueError(f"no kernel instantiation for {ly!r}")


def _launch_stream(tab, m, xi_ptr, pend_ptr, adm_ptr, kw, mode, pass_, key, dev,
                   ly=LAYOUT_TET):
    err = _entry(_layout_entry("stream", ly), m.dtype)(
        tab.data_ptr(), m.data_ptr(), xi_ptr, pend_ptr, adm_ptr, m.shape[0], kw["dt"],
        kw["sigma"], int(kw["use_adv"]), int(kw["use_brown"]),
        int(kw.get("bounce_on", False)), int(kw.get("esc_on", False)),
        kw.get("n_hops", 1), mode, pass_, int(kw.get("rk4", False)), *key, _stream_ptr(dev))
    _raise_on(err, "stream_kernel")


def stream_cycle(tab, m, xi, pending, *, dt, sigma, use_adv, use_brown,
                 bounce_on, esc_on, n_hops, noise_key=None, admit=None, ly=LAYOUT_TET,
                 rk4=False):
    """Stream section of one cycle (K1 + K2), in place on ``m``
    [n, ly.width] with ``tab`` = ``fused.row_table`` [nt, ly.tab_w];
    writes the rare-stage flags into ``pending`` [n] uint8.  With
    ``use_brown``, either ``xi`` [n, 3] (same dtype) or ``noise_key``
    (Philox, module docstring) gives the noise.  ``admit`` [n] uint8 (from
    :func:`hop_admit`) makes it the apply stage of the compacted hop
    gather: a crosser whose flag is 0 skips its hop and goes pending
    (``LAYOUT_TET`` only, as in the JAX package).  ``rk4``: the RK4
    integrator (``stream_kernel<..., kRK4>``, both layouts, without
    ``admit``); its launches are counted in ``.rk4_launches`` too."""
    if admit is not None and ly is not LAYOUT_TET:
        raise ValueError("the compacted hop gather is TetVelocity only")
    if admit is not None and rk4:
        raise ValueError("the RK4 stream has the whole pass only")
    n, dev = _check_tab_m(tab, m, ly.width, ly.tab_w)
    _check("pending", pending, dtype=torch.uint8, shape=(n,), device=dev)
    adm_ptr = _flags("admit", admit, n, dev)
    xi, xi_ptr, mode, key = _noise_args(xi, n, m, use_brown, noise_key)
    _check_hops(n_hops)
    kw = dict(dt=dt, sigma=sigma, use_adv=bool(use_adv), use_brown=bool(use_brown),
              bounce_on=bool(bounce_on), esc_on=bool(esc_on), n_hops=int(n_hops), rk4=bool(rk4))
    if dev.type == "cpu":
        stream_plain(tab, m, xi, pending, admit=admit, ly=ly, **kw)
        return
    if n == 0:
        return
    _launch_stream(tab, m, xi_ptr, pending.data_ptr(), adm_ptr, kw, mode,
                   PASS_WHOLE if admit is None else PASS_ADMITTED, key, dev, ly)
    stream_cycle.launches += 1
    if rk4:
        stream_cycle.rk4_launches += 1


stream_cycle.launches = 0     # of any instantiation
stream_cycle.rk4_launches = 0  # of the RK4 instantiations


def stream_crossers(tab, m, xi, crossers, *, dt, sigma, use_adv, use_brown, noise_key=None):
    """Flag stage of the compacted hop gather: ``stream_kernel``'s sub-step
    up to the hop-0 test, writing each lane's crossing flag (``HMV``) into
    ``crossers`` [n] uint8; ``m`` is left alone.  Noise as in
    :func:`stream_cycle`, and the same as the apply stage's."""
    n, dev = _check_tab_m(tab, m)
    _check("crossers", crossers, dtype=torch.uint8, shape=(n,), device=dev)
    adm_ptr = crossers.data_ptr()
    xi, xi_ptr, mode, key = _noise_args(xi, n, m, use_brown, noise_key)
    kw = dict(dt=dt, sigma=sigma, use_adv=bool(use_adv), use_brown=bool(use_brown))
    if dev.type == "cpu":
        stream_plain(tab, m, xi, None, bounce_on=False, esc_on=False, n_hops=1,
                     crossers=crossers, **kw)
        return
    if n == 0:
        return
    _launch_stream(tab, m, xi_ptr, None, adm_ptr, kw, mode, PASS_CROSSERS, key, dev)
    stream_crossers.launches += 1


stream_crossers.launches = 0


def hop_admit_scratch(n, device):
    """The zeroed int32 scratch ``hop_admit`` takes for up to ``n`` lanes
    (``csrc/hop_admit.cu``: a ticket, a count of finished blocks and one
    status word per tile of 8192 lanes).  The kernel leaves it zeroed, so
    one buffer serves every call on a stream, at any lane count up to n."""
    return torch.zeros(2 + -(-int(n) // ADMIT_TILE), dtype=torch.int32, device=device)


def hop_admit(crossers, admit, *, capb, scratch=None):
    """Admission of the compacted hop gather (K3): ``crossers`` [n] uint8
    -> ``admit`` [n] uint8, 1 for each crosser of an admitted 4-lane group
    (fewer than ``capb`` pending groups before it; ``fused.hop_capacity``)
    with fewer than 2 crossers before it in the group
    (``fused.hop_admit_plain``).  ``scratch``: a buffer from
    :func:`hop_admit_scratch` for at least n lanes, to spare the
    allocation of one per call."""
    if not torch.is_tensor(crossers) or crossers.dim() != 1:
        raise ValueError("crossers must be a 1-d tensor")
    n, dev = crossers.shape[0], crossers.device
    for name, t in (("crossers", crossers), ("admit", admit)):
        _check(name, t, dtype=torch.uint8, shape=(n,), device=dev)
    if int(capb) < 0:
        raise ValueError(f"capb must be >= 0, got {capb}")
    words = 2 + -(-n // ADMIT_TILE)
    if scratch is not None:
        if not torch.is_tensor(scratch) or scratch.dim() != 1 or scratch.shape[0] < words:
            raise ValueError(f"scratch must be a 1-d tensor of at least {words} words "
                             f"(hop_admit_scratch)")
        _check("scratch", scratch, dtype=torch.int32, shape=scratch.shape, device=dev)
    if dev.type == "cpu":
        hop_admit_plain(crossers, admit, capb=int(capb))
        return
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if n == 0:
        return
    _check_flag_alignment(crossers=crossers, admit=admit)
    if scratch is None:
        scratch = hop_admit_scratch(n, dev)
    err = _entry("hop_admit")(crossers.data_ptr(), admit.data_ptr(), scratch.data_ptr(), n,
                              int(capb), _stream_ptr(dev))
    _raise_on(err, "hop_admit_kernel")
    hop_admit.launches += 1


hop_admit.launches = 0


def _launch_macro(tab, m, xi_ptr, phase, pend_ptr, adm_ptr, kw, mode, pass_, key, dev):
    err = _entry("macro_stream", m.dtype)(
        tab.data_ptr(), m.data_ptr(), xi_ptr, phase.data_ptr(), pend_ptr, adm_ptr,
        m.shape[0], kw["k"], kw["dt"], kw["sigma"], int(kw["use_adv"]),
        int(kw["use_brown"]), int(kw.get("bounce_on", False)),
        int(kw.get("esc_on", False)), mode, pass_, *key, _stream_ptr(dev))
    _raise_on(err, "macro_stream_kernel")


def _macro_checks(tab, m, xi, phase, k, use_brown, noise_key):
    n, dev = _check_tab_m(tab, m)
    _check("phase", phase, dtype=torch.uint8, shape=(n,), device=dev)
    if not 1 <= int(k) <= 8:
        raise ValueError(f"k must be in 1..8, got {k}")
    return (n, dev) + _noise_args(xi, n, m, use_brown, noise_key, k=int(k))


def macro_stream(tab, m, xi, phase, pending, *, k, dt, sigma, use_adv, use_brown,
                 bounce_on, esc_on, noise_key=None, admit=None):
    """One trip of a k-sub-step macro cycle (K4), in place on ``m`` [n, 32]
    and ``phase`` [n] uint8 (sub-steps done; 0 before trip 0); writes
    ``pending`` [n] uint8 for the rare stage.  Noise: ``xi`` [k, n, 3] or
    ``noise_key`` (the key of sub-step 0).  ``admit`` as in
    :func:`stream_cycle` (the compacted trips)."""
    n, dev, xi, xi_ptr, mode, key = _macro_checks(tab, m, xi, phase, k, use_brown, noise_key)
    _check("pending", pending, dtype=torch.uint8, shape=(n,), device=dev)
    adm_ptr = _flags("admit", admit, n, dev)
    kw = dict(k=int(k), dt=dt, sigma=sigma, use_adv=bool(use_adv), use_brown=bool(use_brown),
              bounce_on=bool(bounce_on), esc_on=bool(esc_on))
    if dev.type == "cpu":
        macro_stream_plain(tab, m, xi, phase, pending, admit=admit, **kw)
        return
    if n == 0:
        return
    if admit is None:
        _check_flag_alignment(phase=phase, pending=pending)
    _launch_macro(tab, m, xi_ptr, phase, pending.data_ptr(), adm_ptr, kw, mode,
                  PASS_WHOLE if admit is None else PASS_ADMITTED, key, dev)
    macro_stream.launches += 1


macro_stream.launches = 0


def macro_crossers(tab, m, xi, phase, crossers, *, k, dt, sigma, use_adv, use_brown,
                   noise_key=None):
    """Flag stage of a compacted macro trip: ``macro_stream_kernel`` up to
    the stopping sub-step, writing each lane's crossing flag into
    ``crossers`` [n] uint8; ``m`` and ``phase`` are left alone."""
    n, dev, xi, xi_ptr, mode, key = _macro_checks(tab, m, xi, phase, k, use_brown, noise_key)
    _check("crossers", crossers, dtype=torch.uint8, shape=(n,), device=dev)
    adm_ptr = crossers.data_ptr()
    kw = dict(k=int(k), dt=dt, sigma=sigma, use_adv=bool(use_adv), use_brown=bool(use_brown))
    if dev.type == "cpu":
        macro_stream_plain(tab, m, xi, phase, None, bounce_on=False, esc_on=False,
                           crossers=crossers, **kw)
        return
    if n == 0:
        return
    _launch_macro(tab, m, xi_ptr, phase, None, adm_ptr, kw, mode, PASS_CROSSERS, key, dev)
    macro_crossers.launches += 1


macro_crossers.launches = 0


def _check_remote(remote, nbd, nt):
    """(R0, per) of a partitioned shard's table: R0 is the boundary face
    count, ``per`` the slab's rows.  (That the codes and sentinels are
    exact in float32 is ``partition.partition_mesh``'s check.)"""
    R0, per = (int(x) for x in remote)
    if R0 != nbd:
        raise ValueError(f"remote R0={R0} must be the boundary face count {nbd}")
    if per != nt:
        raise ValueError(f"remote per={per} must be the slab's rows {nt}")
    return R0, per


def rare_resolve(tab, m, pending, bd_escape, *, max_hops, max_bounces,
                 reflect_wall, ly=LAYOUT_TET, remote=None):
    """Rare stage (K7), in place on ``m`` [n, ly.width] with ``tab`` =
    ``fused.row_table`` [nt, ly.tab_w]: every lane with ``pending`` set
    runs the bounded walk (max(2, max_hops) hops) and, with
    ``reflect_wall``, up to ``max_bounces`` specular reflections, each
    re-walk bounded by the default 50 hops; ``bd_escape`` [nbd] bool marks
    absorbing faces.  The kernel finds the pending lanes itself, in one
    wave of resident blocks (``csrc/pending.cuh``; no host sync); ``pending``
    may start on any byte.

    ``remote=(R0, per)``: ``tab`` is a partitioned shard's slab of ``per``
    rows (R0 = ``bd_escape``'s length), and the call launches
    ``rare_kernel<T, L, kRemote>``: a lane whose walk, or re-walk after a
    bounce, meets a tet g of another shard pauses with tet -(per + g + 1)
    (``fused.rare_plain(remote=)``).  Its launches are counted in
    ``.remote_launches`` too."""
    n, dev = _check_tab_m(tab, m, ly.width, ly.tab_w)
    _check("pending", pending, dtype=torch.uint8, shape=(n,), device=dev)
    _check("bd_escape", bd_escape, dtype=torch.bool, shape=(bd_escape.shape[0],),
           device=dev)
    kw = dict(max_hops=int(max_hops), max_bounces=int(max_bounces),
              reflect_wall=bool(reflect_wall))
    if remote is not None:
        remote = _check_remote(remote, bd_escape.shape[0], tab.shape[0])
    if dev.type == "cpu":
        rare_plain(tab, m, pending, bd_escape, ly=ly, remote=remote, **kw)
        return
    if n == 0:
        return
    args = (tab.data_ptr(), m.data_ptr(), pending.data_ptr(), bd_escape.data_ptr(), n,
            bd_escape.shape[0], kw["max_hops"], kw["max_bounces"], int(kw["reflect_wall"]))
    if remote is None:
        err = _entry(_layout_entry("rare", ly), m.dtype)(*args, _stream_ptr(dev))
    else:
        err = _entry(_layout_entry("rare_remote", ly), m.dtype)(*args, *remote,
                                                                _stream_ptr(dev))
    _raise_on(err, "rare_kernel")
    rare_resolve.launches += 1
    if remote is not None:
        rare_resolve.remote_launches += 1


rare_resolve.launches = 0         # of any instantiation
rare_resolve.remote_launches = 0  # of the kRemote instantiations


def _grid(entry, n, what):
    blocks = entry(int(n))
    if blocks < 0:
        _raise_on(-blocks, what)
    return blocks


def rare_grid(n, dtype, ly=LAYOUT_TET):
    """Blocks ``rare_kernel``'s instantiation for ``dtype`` and ``ly``
    launches over ``n`` lanes on the current device: min(ceil(n / 256),
    the blocks the card holds at once).  Launches nothing."""
    return _grid(_entry(_layout_entry("rare_grid", ly), dtype), n, "rare_kernel")


def convex_rare_grid(n, dtype):
    """Blocks ``convex_rare_kernel`` launches over ``n`` lanes, as
    :func:`rare_grid`."""
    return _grid(_entry("convex_rare_grid", dtype), n, "convex_rare_kernel")


def _launch_convex_stream(tab, m, xi_ptr, pend_ptr, adm_ptr, disp_ptr, kw, mode, pass_, key,
                          dev):
    err = _entry("convex_stream", m.dtype)(
        tab.data_ptr(), m.data_ptr(), xi_ptr, pend_ptr, adm_ptr, disp_ptr, m.shape[0],
        kw["dt"], kw["sigma"], int(kw["use_adv"]), int(kw["use_brown"]),
        kw.get("n_hops", 1), mode, pass_, *key, _stream_ptr(dev))
    _raise_on(err, "convex_stream_kernel")


def convex_stream_cycle(tab, m, xi, pending, disp, *, dt, sigma, use_adv, use_brown,
                        n_hops, noise_key=None, admit=None):
    """Convex stream section of one cycle (K5), in place on the convex mega
    ``m`` [n, 32] with ``tab`` = ``cx_table`` [nt, 24]; writes ``pending``
    [n] uint8 and the displacement ``disp`` [n, 3].  Noise as in
    :func:`stream_cycle`; ``n_hops`` >= 1 runs the one inline hop.
    ``admit`` [n] uint8: the apply stage of the compacted hop gather (an
    interior crosser whose flag is 0 does not hop and stays pending)."""
    n, dev = _check_tab_m(tab, m, fused_convex.WIDTH, fused_convex.ROW_W)
    _check("pending", pending, dtype=torch.uint8, shape=(n,), device=dev)
    _check("disp", disp, dtype=m.dtype, shape=(n, 3), device=dev)
    adm_ptr = _flags("admit", admit, n, dev)
    xi, xi_ptr, mode, key = _noise_args(xi, n, m, use_brown, noise_key)
    _check_hops(n_hops)
    kw = dict(dt=dt, sigma=sigma, use_adv=bool(use_adv), use_brown=bool(use_brown),
              n_hops=int(n_hops))
    if dev.type == "cpu":
        fused_convex.convex_stream_plain(tab, m, xi, pending, disp, admit=admit, **kw)
        return
    if n == 0:
        return
    _launch_convex_stream(tab, m, xi_ptr, pending.data_ptr(), adm_ptr, disp.data_ptr(), kw,
                          mode, PASS_WHOLE if admit is None else PASS_ADMITTED, key, dev)
    convex_stream_cycle.launches += 1


convex_stream_cycle.launches = 0


def convex_stream_crossers(tab, m, xi, crossers, *, dt, sigma, use_adv, use_brown,
                           noise_key=None):
    """Flag stage of the compacted convex hop gather: ``convex_stream_kernel``
    up to the hop-0 exit test, writing each lane's interior-crossing flag
    (``CINT``) into ``crossers`` [n] uint8; ``m`` is left alone."""
    n, dev = _check_tab_m(tab, m, fused_convex.WIDTH, fused_convex.ROW_W)
    _check("crossers", crossers, dtype=torch.uint8, shape=(n,), device=dev)
    adm_ptr = crossers.data_ptr()
    xi, xi_ptr, mode, key = _noise_args(xi, n, m, use_brown, noise_key)
    kw = dict(dt=dt, sigma=sigma, use_adv=bool(use_adv), use_brown=bool(use_brown))
    if dev.type == "cpu":
        fused_convex.convex_stream_plain(tab, m, xi, None, None, n_hops=1, crossers=crossers,
                                         **kw)
        return
    if n == 0:
        return
    _launch_convex_stream(tab, m, xi_ptr, None, adm_ptr, None, kw, mode, PASS_CROSSERS, key,
                          dev)
    convex_stream_crossers.launches += 1


convex_stream_crossers.launches = 0


def convex_rare_resolve(mesh, tab, m, disp, pending, *, max_hops, reflect_wall,
                        bary_fix, max_bounces):
    """Convex rare stage, in place on ``m``: every lane with ``pending``
    set traces its segment from the pos columns by ``disp`` (``max_hops``
    tets), and with ``reflect_wall`` reflects (at most 5 bounces, each
    re-trace 50 tets) and, with ``bary_fix``, runs the barycentric walk +
    ``reflect_walls`` (``max_bounces``) on the landed point.  Reads the
    mesh's ``tet_row_cx``, ``tet_a``, ``tet_tinv``, ``tet_nbr``,
    ``tet_face_n``, ``tet_face_d`` and ``bd_escape``.  The kernel finds
    the pending lanes itself, as :func:`rare_resolve`'s does."""
    n, dev = _check_tab_m(tab, m, fused_convex.WIDTH, fused_convex.ROW_W)
    _check("pending", pending, dtype=torch.uint8, shape=(n,), device=dev)
    _check("disp", disp, dtype=m.dtype, shape=(n, 3), device=dev)
    if mesh.tet_row_cx is None:
        raise ValueError("the convex rare stage needs mesh.with_convex_rows(mesh)")
    nt, nbd = mesh.n_tets, mesh.n_bd_faces
    _check("tab", tab, dtype=m.dtype, shape=(nt, fused_convex.ROW_W), device=dev)
    for name, t, dtype, shape in (
        ("tet_row_cx", mesh.tet_row_cx, m.dtype, (nt, fused_convex.ROW_W)),
        ("tet_a", mesh.tet_a, m.dtype, (nt, 3)),
        ("tet_tinv", mesh.tet_tinv, m.dtype, (nt, 3, 3)),
        ("tet_nbr", mesh.tet_nbr, torch.int32, (nt, 4)),
        ("tet_face_n", mesh.tet_face_n, m.dtype, (nt, 4, 3)),
        ("tet_face_d", mesh.tet_face_d, m.dtype, (nt, 4)),
        ("bd_escape", mesh.bd_escape, torch.bool, (nbd,)),
    ):
        _check(name, t, dtype=dtype, shape=shape, device=dev)
    if dev.type == "cuda" and mesh.tet_row_cx.data_ptr() % 16:
        raise ValueError("tet_row_cx must start on a 16-byte boundary")   # 16 B row loads
    kw = dict(max_hops=int(max_hops), reflect_wall=bool(reflect_wall),
              bary_fix=bool(bary_fix), max_bounces=int(max_bounces))
    if dev.type == "cpu":
        fused_convex.convex_rare_plain(mesh, tab, m, disp, pending, **kw)
        return
    if n == 0:
        return
    err = _entry("convex_rare", m.dtype)(
        tab.data_ptr(), mesh.tet_row_cx.data_ptr(), mesh.tet_a.data_ptr(),
        mesh.tet_tinv.data_ptr(), mesh.tet_nbr.data_ptr(), mesh.tet_face_n.data_ptr(),
        mesh.tet_face_d.data_ptr(), mesh.bd_escape.data_ptr(), m.data_ptr(),
        disp.data_ptr(), pending.data_ptr(), n, nbd, kw["max_hops"],
        int(kw["reflect_wall"]), int(kw["bary_fix"]), kw["max_bounces"],
        _stream_ptr(dev))
    _raise_on(err, "convex_rare_kernel")
    convex_rare_resolve.launches += 1


convex_rare_resolve.launches = 0
