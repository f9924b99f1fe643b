"""Gradients of the port's ``loss_fn`` against ``jax.value_and_grad`` of
``repro.models.loss_fn`` for the two recurrent reduced architectures,
recurrentgemma (RG-LRU) and xlstm (mLSTM and sLSTM), as
``tests/test_torch_train_grads.py`` holds the others, with ``tol = 5e-3``
(``tests/torch_lm_parity.py``); and remat on equal to remat off, bit for
bit."""
import pytest

pytest.importorskip("jax")

from torch_lm_parity import RECURRENT, check_loss_and_grads, check_remat  # noqa: E402


@pytest.mark.parametrize("arch", RECURRENT)
def test_loss_and_grads_equal_the_reference(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", RECURRENT)
def test_remat_changes_nothing_but_memory(arch):
    check_remat(arch)
