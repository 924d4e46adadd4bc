"""The distributed prover on ``torch.distributed``.

Counterpart of the JAX package's ``parallel/``.  There one process drives a
whole device mesh and GSPMD places the work; here each rank is a process
(one per GPU, started by ``torchrun`` or :func:`dryrun.dryrun_multichip`),
every rank runs the same protocol code, and :class:`engine.DistEngine`
splits the heavy device work over the ranks and joins it with explicit
collectives (:mod:`collectives`).  Modules: :mod:`mesh` (device meshes and
a rank's block of an axis), :mod:`multihost` (process-group start-up and
the hybrid (proof, shard) mesh), :mod:`ntt_dist` (the four-step NTT with
one all-to-all), :mod:`engine` (single and distributed engines) and
:mod:`dryrun` (a multi-process dry run of the distributed prover).
"""
