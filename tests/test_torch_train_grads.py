"""Gradients of the port's ``loss_fn`` against ``jax.value_and_grad`` of
``repro.models.loss_fn`` for the eight attention, MoE and audio reduced
architectures (the two recurrent ones: ``tests/test_torch_train_grads_recurrent.py``),
on JAX's parameters and a numpy batch with masked labels (paligemma: labels
on the tokens after its image prefix, the loss's tail alignment): the total,
``ce`` and ``aux``, and every gradient leaf by the per-leaf rule
``max|diff| <= 1e-4 * max(1, max|g|)`` (``tests/torch_lm_parity.py``). Then
``remat``: each group recomputed in backward gives the same loss and
gradients, bit for bit, as keeping the activations."""
import pytest

pytest.importorskip("jax")

from torch_lm_parity import RECURRENT, check_loss_and_grads, check_remat  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402

ARCHS = [a for a in ARCH_IDS if a not in RECURRENT]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_equal_the_reference(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_nothing_but_memory(arch):
    check_remat(arch)
