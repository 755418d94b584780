"""repro_torch.launch — command-line entry points.

Ported: ``serve`` (the batched serving demo of every family), ``train``
(training on one device) and ``mesh``'s array mesh (``make_array_mesh``,
``chips``). Still to come from the reference package: ``dryrun``,
``roofline``, ``shapes``, and ``mesh``'s model meshes (ROADMAP Queue A
item 9b).
"""
