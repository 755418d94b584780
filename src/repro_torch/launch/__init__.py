"""repro_torch.launch — command-line entry points.

Ported: ``serve`` (the batched serving demo of the dense family) and
``mesh``'s array mesh (``make_array_mesh``, ``chips``). Still to come from
the reference package: ``train``, ``dryrun``, ``roofline``, ``shapes``, and
``mesh``'s model meshes (ROADMAP Queue A item 9).
"""
