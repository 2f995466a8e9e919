"""The port's stage-2 training step (`--dc`, dec_id 1: decoder adapters
and the dc freezing) against JAX `make_train_step` on the CPU, in f32, at
rep_size "t", 64x96, B=2, under the setup and bounds of
tests/test_torch_train_step.py (its helpers run both steps): the same
trainable set, loss and metrics, gradients leaf by leaf, Adam's moments,
the updated parameters with every frozen one bit-unchanged, BN running
statistics and the depth bins. Every parameter, the adapters' D_fc2 and
the deconv kernels included, is drawn away from zero, so the adapters
take part in the step. The JAX step is this file's one compile."""

import pytest

from tests import test_torch_train_step as S1
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)

OPT = S1.OPT.replace(dc=True, dec_id=1)


@pytest.fixture(scope="module")
def jax_run():
    return S1.run_jax_step(OPT)


@pytest.fixture(scope="module")
def port_run(jax_run):
    return S1.run_port_step(jax_run)


def test_stage2_trainable_set_matches_jax(jax_run, port_run):
    """The dc labels give the JAX step's trainable set: in the decoders only
    `adapter` and `deconv_adpt`."""
    S1.test_trainable_set_matches_jax_labels(jax_run, port_run)
    names = {n for n, p in port_run[0].named_parameters() if p.requires_grad}
    decoders = {n.split(".")[1] for n in names
                if n.split(".")[0] in ("depth", "mono_depth")}
    assert decoders == {"adapter", "deconv_adpt"}


def test_stage2_step_loss_and_metrics_match_jax(jax_run, port_run):
    S1.test_step_loss_and_metrics_match_jax(jax_run, port_run)


def test_stage2_step_gradients_match_jax(jax_run, port_run):
    S1.test_step_gradients_match_jax(jax_run, port_run)


def test_stage2_step_adam_moments_match_jax(jax_run, port_run):
    S1.test_step_adam_moments_match_jax(jax_run, port_run)


def test_stage2_step_updated_parameters_match_jax(jax_run, port_run):
    """As stage 1's, frozen parameters (the decoder trunks and heads
    among them) bit-unchanged."""
    S1.test_step_updated_parameters_match_jax(jax_run, port_run)


def test_stage2_step_batch_stats_match_jax(jax_run, port_run):
    S1.test_step_batch_stats_match_jax(jax_run, port_run)


def test_stage2_step_depth_bins_match_jax(jax_run, port_run):
    S1.test_step_depth_bins_match_jax(jax_run, port_run)
