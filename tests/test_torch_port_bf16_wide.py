"""NaCAGaT ``big`` (E = F = D = 512) under bfloat16 compute against the JAX
package on the CPU: the plain versions of the E = F = 512 bfloat16 fuse-K
forward (eval and training forms) and backward, and of the D = 512 export
passes, against the Pallas kernels in interpret mode at bfloat16 on the
masks of ``test_torch_port_bf16.py``; and NaCAGaT ``big`` built with
``dtype=torch.bfloat16`` against the JAX model with ``dtype=jnp.bfloat16``
(``cesar``, dropout 0, M = 512). A file of its own, so that ``--dist
loadfile`` can give it another worker than ``test_torch_port_bf16.py``.

The cases are that file's (its ``check_*`` helpers) at 512, at its bars
(o one bfloat16 unit, 2^-7 of its largest magnitude; the export passes'
statistics and weights 1e-5 of their largest; gradients 3e-2 of their
largest; the model's hazards and loss 5e-3, its gradients leaf by leaf),
with two exceptions, each measured:

* the fuse-K forward's statistics (l, m, ssq, sumw) within 2.5e-5 of their
  largest magnitude, where 256 holds 1e-5. Measured 1.22e-5 (ssq), 1.05e-5
  (l), 6.9e-6 (m) at 512 against 1.5e-6 at 256: k = kv wk + bk sums twice
  the terms at F = 512 (and each score twice the products), so an element
  of k lands on the other side of a bfloat16 rounding in the two
  frameworks' float32 sums more often, and a key whose k moves by a unit
  (2^-8 relative) moves its score, and l, by that much;
* the ``big`` model's hazards, export map and loss within 5e-3 (``small``'s
  bar) or within twice the distance bfloat16 moves each in JAX (its float32
  outputs, its bfloat16 ones at weights nudged by 1e-6 and 1e-4 of
  themselves), as ``small``'s gradients are held: bfloat16's roundings
  move ``big`` further than ``small``, in JAX too (JAX's own distances: eval
  hazards 5.4e-3, the map 2.0e-2, where a bfloat16 unit near 1 is 3.9e-3,
  training hazards 6.1e-3, loss 4.4e-3; the port reads 0.62, 0.40, 1.49
  and 0.31 of them, printed by the test).

The gradients keep ``small``'s rule leaf by leaf (worst: 1.35 of JAX's own
distance, ``co_attention.cag.fc_c.bias``). That rule holds on these weights
(``_jax_params`` names its PRNG) and not on every draw: on the weights the
``rbg`` PRNG draws (``_jax_params(..., impl="rbg")``) ``fusion_layer.fc2``'s
weight and bias read 3.15 and 3.07 of JAX's own distance, every other leaf
at most 1.62. The cause is a ReLU gate: fc2's output passes a ReLU, and
bfloat16 moves fc2's float32 pre-activations by up to 0.061 in the port and
0.054 in JAX (99th percentiles 0.043 and 0.046: the same spread), which flips
the gates whose float32 value lies that close to 0 (25-27 of 1024) at random:
two in each framework on that draw, different ones. One the port flips (bag
2, unit 11: float32 -0.0325, bfloat16 +0.0036; JAX's bfloat16 -0.0300) sends
that bag's gradient through unit 11's row of fc2, which holds the whole
distance (0.0167 of the bias, 0.0664 of the weight; 7.3e-4 and 3.9e-3
everywhere else). JAX's witnesses keep their gates as JAX's bfloat16 run
keeps them, so they cannot show it.
"""

import pytest

torch = pytest.importorskip("torch")

import test_torch_port_bf16 as bf16  # noqa: E402
from test_torch_port_bf16 import MASKS  # noqa: E402

WIDE = 512
WIDE_STAT_RTOL = 2.5e-5


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two torch threads while this file runs: the suite's six workers on
    eight cores, each with a thread a core, oversubscribe them (the host-fed
    Trainers here then run several times slower than alone)."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("m_len,case", MASKS)
@pytest.mark.parametrize("form", ["eval", "train"])
def test_bf16_fused_k_forward_e512_matches_pallas(form, m_len, case):
    """The bfloat16 fuse-K forward's plain version at E = F = 512, eval and
    training forms (dropout 0), against the Pallas forward on bfloat16
    tiles."""
    bf16.check_fused_k_forward(form, WIDE, m_len, case, WIDE_STAT_RTOL)


@pytest.mark.parametrize("m_len,case", MASKS[:3])
def test_bf16_fused_k_backward_e512_matches_pallas(m_len, case):
    """dq, dkv, dwk, dbk at E = F = 512 against jax.grad through the Pallas
    kernels at bfloat16; dkv exactly 0 at the masked keys of a bag with a
    valid key."""
    bf16.check_fused_k_backward(WIDE, m_len, case)


@pytest.mark.parametrize("m_len,case", MASKS)
@pytest.mark.parametrize("pre_gate", [True, False], ids=["pre-gate", "no-pre-gate"])
def test_bf16_export_passes_d512_match_pallas(pre_gate, m_len, case):
    """The export passes' bfloat16 plain versions at D = 512: (l, m) and the
    weights against the Pallas kernels."""
    bf16.check_export_passes(pre_gate, WIDE, m_len, case)


def test_nacagat_big_bf16_matches_jax(monkeypatch):
    """NaCAGaT ``big`` at bfloat16 compute (the lean-V branch at E = F =
    512, the export map at D = 512) against the JAX model at bfloat16 on the
    same parameters: eval hazards and map, a training forward's hazards,
    loss and every parameter's gradient."""
    bf16.check_survival_model_bf16("NaCAGaT", "cesar", "big", monkeypatch, witnessed=True)
