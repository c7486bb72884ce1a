"""Multi-device particle strategies (port of ``cudaparticlesfoam_tpu/parallel/``:
``sharding``, ``auto`` and ``partition``).

* :mod:`.sharding`: particle data parallelism.  The mesh is replicated on
  every device, the particles are split into shards, and each shard runs
  the single-device cached engine (``stream_kernel`` + ``rare_kernel``).
* :mod:`.partition`: a slab-partitioned mesh.  Each shard holds one slab of
  the walk table; a walk that meets a tet of another slab pauses
  (``rare_kernel<T, L, kRemote>``), and the paused particles migrate in a
  fixed-capacity exchange.
* :mod:`.auto`: ``choose_strategy`` and ``ParticleEngine``, the one
  interface the drivers use.

**One controller, an explicit shard axis.**  The JAX package is one
process: a ``shard_map`` or GSPMD program over a device mesh, and on a host
with one chip it dry-runs S shards on virtual CPU devices.  The port keeps
that model.  ``make_device_mesh(n)`` returns a list of ``torch.device``;
shard ``s`` lives on ``devices[s]``, and the per-shard body is a Python
loop over the shards, each shard's launches under ``torch.cuda.device`` of
its own card, on that card's current stream.  JAX's
``lax.all_to_all(x, "s", split_axis=0, concat_axis=0)`` becomes
:func:`.partition.all_to_all`: ``recv[d] = stack([send[s][d] for s])``, a
copy to ``devices[d]`` that does nothing when the shards share a card.

Why not ``torch.distributed`` with NCCL: NCCL refuses two ranks on one
GPU, so on a machine with one card the partitioned path could never run
there with more than one shard; the CPU tests would need spawned gloo
processes; and the JAX package's CLI runs in one process.  When a caller
asks for more CUDA shards than ``torch.cuda.device_count()`` gives, the
shards share the visible cards in turn (``cuda:0 x4`` on one card): the
port's version of JAX's virtual-device dry run, but on the card, never on
the CPU.  A CPU caller (the tests) gets S shards on ``cpu``.

Not measured: shards on distinct cards (the wrappers check that each
launch runs under its tensors' device; one card cannot test the copies
between cards).
"""
