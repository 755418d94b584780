"""repro_torch.launch — command-line entry points.

Ported: ``serve`` (the batched serving demo of the dense family). Still to
come from the reference package: ``train``, ``dryrun``, ``roofline``,
``shapes``, ``mesh`` (ROADMAP Queue A items 4 and 9).
"""
