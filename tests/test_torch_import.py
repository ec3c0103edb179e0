"""repro_torch stands alone: importing every one of its modules pulls in
neither jax nor any module of the JAX package ``repro``, and builds no
CUDA kernel (kernels build at first use, on the card)."""
import json
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for n in names:
    importlib.import_module(n)
from repro_torch.kernels import _build, ops
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": names, "bad": bad, "built": _build.loaded(),
                  "launches": ops.launch_counts()}))
"""


def test_import_pulls_in_no_jax_and_builds_nothing(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", PROBE], env=env,
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    for m in ("repro_torch.core.search_torch", "repro_torch.core.build",
              "repro_torch.kernels.ops", "repro_torch.data.vectors",
              "repro_torch.configs.sift1m_phnsw",
              "repro_torch.core.distributed",
              "repro_torch.distributed.faults",
              "repro_torch.kernels.flash_attention",
              "repro_torch.kernels.decode_attention",
              "repro_torch.bench.kernel_footprint",
              "repro_torch.bench.compact_cost",
              "repro_torch.configs.base", "repro_torch.core.graph",
              "repro_torch.obs", "repro_torch.obs.metrics",
              "repro_torch.obs.trace", "repro_torch.obs.export",
              "repro_torch.distributed.fault",
              "repro_torch.index", "repro_torch.index.mutable",
              "repro_torch.index.sharded", "repro_torch.serve",
              "repro_torch.serve.vector_service",
              "repro_torch.serve.replica",
              "repro_torch.serve.scheduler", "repro_torch.bench.load",
              "repro_torch.core.search_ref",
              "repro_torch.core.cost_model", "repro_torch.core.kselect",
              "repro_torch.obs.bridge", "repro_torch.bench.common",
              "repro_torch.bench.table3_qps",
              "repro_torch.bench.fig5_energy",
              "repro_torch.bench.fig2_kselect",
              "repro_torch.bench.build", "repro_torch.bench.churn",
              "repro_torch.bench.faults", "repro_torch.bench.pq_ablation",
              "repro_torch.bench.run",
              "repro_torch.configs.registry",
              "repro_torch.configs.starcoder2_3b",
              "repro_torch.models", "repro_torch.models.common",
              "repro_torch.models.rope", "repro_torch.models.layers",
              "repro_torch.models.attention",
              "repro_torch.models.retrieval_attention",
              "repro_torch.models.transformer", "repro_torch.models.api",
              "repro_torch.models.moe", "repro_torch.models.encdec",
              "repro_torch.models.rglru", "repro_torch.models.hybrid",
              "repro_torch.models.rwkv6", "repro_torch.models.ssm",
              "repro_torch.serve.engine", "repro_torch.data.tokens",
              "repro_torch.launch", "repro_torch.launch.serve",
              "repro_torch.launch.steps", "repro_torch.launch.train",
              "repro_torch.optim", "repro_torch.optim.adamw",
              "repro_torch.optim.compression", "repro_torch.checkpoint",
              "repro_torch.checkpoint.ckpt", "repro_torch.train",
              "repro_torch.train.loop", "repro_torch.distributed.sharding",
              "repro_torch.distributed.pipeline", "repro_torch.launch.mesh",
              "repro_torch.launch.step_cost", "repro_torch.launch.dryrun",
              "repro_torch.launch.roofline"):
        assert m in got["modules"]
    assert got["bad"] == []
    assert got["built"] == []
    assert set(got["launches"].values()) == {0}


def test_chip_smoke_imports_no_jax():
    """``chip_smoke.py`` runs where only PyTorch is installed: none of
    its imports, at module level or inside a phase, names jax or the JAX
    package."""
    import ast
    tree = ast.parse((SRC.parent / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert "repro_torch.serve" in names
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib",
                                                   "repro")]
    assert bad == []
