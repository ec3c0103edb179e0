"""Launchers (port of ``repro/launch``): ``serve``, LM generation or
pHNSW vector search; ``train``, the training loop; ``steps``, the train,
prefill and serve steps on one card or on a mesh, and ``lower_step``;
``mesh``, the production, host and abstract meshes; the dry-run tools
``step_cost`` (the per-position step cost counter), ``dryrun`` and
``roofline``."""
