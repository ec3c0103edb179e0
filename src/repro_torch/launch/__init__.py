"""Launchers (port of ``repro/launch``): ``serve``, LM generation or
pHNSW vector search; ``train``, the training loop, with ``steps``
(``build_train_step``, one card). The dry-run and mesh tools wait for
the mesh port (ROADMAP.md A10d)."""
