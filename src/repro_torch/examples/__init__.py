"""The documented walk-throughs, one module per script of the reference's
``examples/``, each run as ``python -m repro_torch.examples.<name>``.

Every example keeps its reference script's flags and adds ``--device``
(default ``cuda``, which raises without a card; ``--device cpu`` runs the
plain PyTorch versions). ``main(argv=None)`` prints the reference's lines
and returns a dict of the figures it printed. Nothing runs at import.

* ``quickstart``          — CP-ALS exact and on ``"psram-oracle"``, the §V model.
* ``backend_tour``        — one MTTKRP through every registered backend, the drift table.
* ``sparse_decompose``    — sparse CP-ALS on the streaming schedule, its price, a mesh split.
* ``decompose_weights``   — CP of MoE expert weights on ``"psram-stream"`` / ``"psram-mesh"``.
* ``photonic_offload``    — pSRAM projections, kernel 2 against the oracle, the tile schedule.
* ``fault_tolerance``     — inject, detect (ABFT), recover, degrade.
* ``serve_requests``      — a request stream through ``ServeLoop``.
* ``continuous_batching`` — Poisson vs bursty arrivals on a tight page pool.
* ``train_lm``            — ``Trainer`` with checkpoints and a restart.
"""
