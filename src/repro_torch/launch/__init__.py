"""repro_torch.launch — command-line entry points and the dry run.

``serve`` (the batched serving demo of every family), ``train`` (training
on one device, or under ``dist.sharding`` on a host mesh; ``--distributed``
one process a card under torchrun), ``mesh`` (``init_distributed``, the
model meshes ``make_production_mesh`` / ``make_host_mesh`` and their
``DeviceMesh``, the array mesh ``make_array_mesh``, ``chips``), ``shapes``
(the assigned cell shapes), ``roofline`` (the H100's roofline arithmetic,
``analyze_step`` and the collective term under a fake process group) and
``dryrun`` (every arch x shape x mesh cell traced on ``meta``, or run on
the card).
"""
