"""Command-line drivers of the port (``python -m repro_torch.launch.X``).

Ported, with the reference's flags, printed lines and gates plus
``--device`` (CUDA by default, raising without a card; ``--device cpu``
on the CPU):

* ``encode`` — the paper's pipeline: VGG16-shaped or any architecture's
  ``--backbone`` features, or a streamed ``--store``; ``--save-bundle``.
* ``wholebrain`` — materialise → fit → ab → crash gate → serve at the
  whole-brain target width, each phase in its own process.
* ``serve`` — LLM decoding of every architecture (``--arch``), the
  encoder serving loop (``--encoders``, ``--replay-trace``) and its
  worker fleet (``--workers``, ``--kill-worker``).
* ``train`` — the training loop over a device mesh
  (``steps.build_train_step``: loss, backward, AdamW on DTensors;
  checkpoints every ``--ckpt-every`` steps), one process or several
  under ``python -m torch.distributed.run``.
* ``obs_report`` — span tables and the coverage gate of a trace;
  ``obscli`` wires ``--trace-out``/``--metrics-out`` into every driver.
* ``roofline_report`` — ``encoding_roofline`` of a ridge-CV fit.

Modules the drivers build on: ``mesh`` (the production and host meshes,
the H100 constants), ``steps`` (the rule tables' shardings and the
sharded train, prefill and decode steps, ``build_step``) and
``hlo_analysis`` (collective bytes counted at a step's collectives, the
roofline terms).

``encode`` also runs under ``python -m torch.distributed.run`` (B-MOR,
dual B-MOR, sharded streaming over the ranks; ``--dist-backend``).

Not ported yet (ROADMAP queue 1 item 12 (3), steps 6–7): ``dryrun``,
``perf`` and the rest of ``roofline_report``; of ``hlo_analysis`` the
HLO-text parser, which has no PyTorch counterpart.
"""
