"""repro_torch.launch — command-line entry points and the dry run.

``serve`` (the batched serving demo of every family), ``train`` (training
on one device, or under ``dist.sharding`` on a host mesh), ``mesh`` (the
model meshes ``make_production_mesh`` / ``make_host_mesh``, the array mesh
``make_array_mesh``, ``chips``), ``shapes`` (the assigned cell shapes),
``roofline`` (the H100's roofline arithmetic and ``analyze_step``) and
``dryrun`` (every arch x shape x mesh cell traced on ``meta``, or run on
the card).
"""
