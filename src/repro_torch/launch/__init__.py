"""Launchers (port of ``repro/launch``): ``serve``, LM generation or
pHNSW vector search. The dry-run, mesh and training launchers are not
ported yet (ROADMAP.md A10)."""
