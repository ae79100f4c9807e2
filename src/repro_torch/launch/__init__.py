"""Command-line drivers of the port (``python -m repro_torch.launch.X``).

Ported, with the reference's flags, printed lines and gates plus
``--device`` (CUDA by default, raising without a card; ``--device cpu``
on the CPU):

* ``encode`` — the paper's pipeline: ``--backbone vgg16|zamba2-2.7b|
  mamba2-130m`` features or a streamed ``--store``, ``--save-bundle``.
* ``wholebrain`` — materialise → fit → ab → crash gate → serve at the
  whole-brain target width, each phase in its own process.
* ``serve`` — the encoder serving loop (``--encoders``,
  ``--replay-trace``) and its worker fleet (``--workers``,
  ``--kill-worker``).
* ``obs_report`` — span tables and the coverage gate of a trace;
  ``obscli`` wires ``--trace-out``/``--metrics-out`` into every driver.
* ``roofline_report`` — ``encoding_roofline`` only.

Not ported: the multi-device plans the drivers reach (``--solver
bmor|bmor_dual``, ``--target-shards > 1``: ROADMAP queue 1 item 9);
``serve --arch`` LLM decoding, the other architectures, ``train``,
``steps``, ``mesh``, ``dryrun``, ``perf``, the rest of
``roofline_report`` and ``hlo_analysis`` (item 12).
"""
