"""The dry-run's step costs (``launch.steps.lower_step``,
``launch.step_cost``) against the JAX package's: the reference's
``hlo_cost`` of its ``lower_step(...).compile().as_text()`` on a (1, 1)
Auto-axis mesh (its ``make_host_mesh`` has Explicit axes, which its
``with_sharding_constraint`` refuses under jax 0.9; ROADMAP.md C), the
port's ``lower_step(...).cost()`` on the abstract (1, 1) mesh, for all
ten archs at their smoke configs, batch 4: prefill and decode at
sequence 16, training at 1,024 (two chunks of the reference's
``chunked_xent``), FLOPs exactly.

Dot bytes: equal in training; at prefill and decode the reference's jnp
attention oracle is two dots that write and read its f32 score and
probability matrices [B, H, S, T], where the port's attention operators
(B8, B9) count q, k, v and their output, so the reference counts
2 x 4 B H S T bytes more a call (S = 1 at decode), and exactly that.

At sequence 16 training keeps one gap: the reference counts one logits
matmul fewer, 2 B S d V FLOPs (2,097,152 at starcoder2-3b's smoke
config). Its checkpointed ``chunked_xent`` (``repro/models/layers.py:
105``) scans one chunk of 512 positions there, and XLA merges that one
trip's recompute of the logits with the forward's; from two chunks on
the counts agree."""
import jax
import pytest
import torch
from jax.sharding import AxisType
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ShapeConfig as JShape
from repro.launch.hlo_cost import hlo_cost
from repro.launch.steps import lower_step as j_lower_step
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.launch.steps import lower_step

BATCH = 4
CELLS = [(arch, kind, seq) for arch in ARCH_IDS
         for kind, seq in (("prefill", 16), ("decode", 16), ("train", 1024))]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_cost(arch, kind, seq):
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    lowered = j_lower_step(j_smoke(arch), mesh,
                           JShape("s", seq, BATCH, kind))
    return hlo_cost(lowered.compile().as_text())


class _Attention(TorchDispatchMode):
    """The (B, H, S, T) of every B8 / B9 call under it (S = 1 at decode)."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        packet = func._overloadpacket
        if packet is torch.ops.repro_torch.flash_attention:
            B, H, S, _ = args[0].shape
            self.calls.append((B, H, S, args[1].shape[2]))
        elif packet is torch.ops.repro_torch.decode_attention:
            B, H, _ = args[0].shape
            self.calls.append((B, H, 1, args[1].shape[2]))
        return func(*args, **(kwargs or {}))


def port_cost(arch, kind, seq):
    """(the summed ``Cost`` on the abstract (1, 1) mesh, the attention
    operators' calls)."""
    probe = _Attention()
    with probe:
        cost = lower_step(get_smoke_config(arch),
                          abstract_mesh((1, 1), ("data", "model")),
                          ShapeConfig("s", seq, BATCH, kind)).cost()
    return cost, probe.calls


@pytest.mark.parametrize("arch,kind,seq", CELLS)
def test_step_cost_matches_reference_hlo_cost(arch, kind, seq):
    want = reference_cost(arch, kind, seq)
    cost, calls = port_cost(arch, kind, seq)
    got = cost.total
    assert got.flops == want.flops
    assert cost.busiest.flops == got.flops           # one position
    assert want.dot_bytes - got.dot_bytes == sum(
        2 * 4 * B * H * S * T for B, H, S, T in calls)
    if kind == "train":
        assert calls == []                # training takes blocked_attention
    assert got.collective_bytes == 0 == want.collective_bytes


def test_one_logits_matmul_gap_at_sequence_16():
    cfg = get_smoke_config("starcoder2-3b")
    want = reference_cost("starcoder2-3b", "train", 16)
    got = port_cost("starcoder2-3b", "train", 16)[0].total
    assert got.flops - want.flops == 2 * BATCH * 16 * cfg.d_model \
        * cfg.vocab == 2_097_152
