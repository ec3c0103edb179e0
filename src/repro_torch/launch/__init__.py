"""Launchers (port of ``repro/launch``): ``serve``, LM generation or
pHNSW vector search; ``train``, the training loop; ``steps``, the train,
prefill and serve steps on one card or on a mesh; ``mesh``, the
production and host meshes. The dry-run tools (``lower_step``,
``dryrun``, ``hlo_cost``, ``roofline``) wait for ROADMAP.md A10e."""
