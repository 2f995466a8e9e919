"""The port's DynamicDepth cost volume (`--dyn_cv`) against JAX in f32 at
two lookup frames, one of a pose of zeros (skipped), over cv_min on and off
x the in-fill (`set_1`, `pool`, neither): the two-frame cases of
tests/test_torch_dyn_cv.py, whose checks and bounds they share (a file of
their own keeps every port test file behind tests/test_train_step.py in
pytest-xdist's file queue).
"""

import pytest

from tests.test_torch_dyn_cv import MODES, check_dyn_cost_volume
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("F_", [2])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("cv_min", [False, True], ids=["average", "cv_min"])
def test_dyn_cost_volume_matches_jax(cv_min, mode, F_):
    """Two lookup frames (one: tests/test_torch_dyn_cv.py)."""
    check_dyn_cost_volume(cv_min, mode, F_)
