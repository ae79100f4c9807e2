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
* ``dryrun`` — every (architecture × input shape) step traced on fake
  tensors as rank 0 of a fake 256-rank world (512 with ``--multi-pod``):
  memory per device, FLOPs, bytes and collective bytes, with the cost
  probes; ``perf`` — the same with optimisation levers, and the roofline
  terms; ``roofline_report`` — the roofline table of their JSONL, and
  ``encoding_roofline``/``predict_roofline`` of a ridge-CV fit and a
  serving pass.  These three need no card and claim none:
  ``PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b
  --shape train_4k --json d.jsonl``, ``python -m
  repro_torch.launch.perf --arch gemma2-2b --shape decode_32k --json
  d.jsonl``, ``python -m repro_torch.launch.roofline_report d.jsonl``
  (``chip_smoke.py`` phase 21 runs them on the card's host).

Modules the drivers build on: ``mesh`` (the production and host meshes,
the H100 constants), ``steps`` (the rule tables' shardings and the
sharded train, prefill and decode steps, ``build_step``) and
``hlo_analysis`` (collective bytes counted at a step's collectives,
``count_costs`` at the ops a rank runs, the roofline terms).

``encode`` also runs under ``python -m torch.distributed.run`` (B-MOR,
dual B-MOR, sharded streaming over the ranks; ``--dist-backend``).

Not ported: of ``hlo_analysis`` the HLO-text parser, which has no
PyTorch counterpart (the port counts at the collectives a step issues).
"""
