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
* ``train`` — the training loop on one device (``steps.build_train_step``:
  loss, backward, AdamW; checkpoints every ``--ckpt-every`` steps).
* ``obs_report`` — span tables and the coverage gate of a trace;
  ``obscli`` wires ``--trace-out``/``--metrics-out`` into every driver.
* ``roofline_report`` — ``encoding_roofline`` and the three-term
  ``roofline_terms``.

``encode`` also runs under ``python -m torch.distributed.run`` (B-MOR,
dual B-MOR, sharded streaming over the ranks; ``--dist-backend``).

Not ported (ROADMAP queue 1 item 12): ``mesh``, ``dryrun``, ``perf``,
``hlo_analysis``, the rest of ``roofline_report``, and of ``steps`` the
shardings, the prefill and decode steps and ``build_step``.
"""
