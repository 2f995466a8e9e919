"""Kernel C's wrapper (`kernels.cost_volume.plane_sweep`) on the CPU: CPU
tensors take the plain version and launch nothing, and bad inputs raise
before any launch. Split from tests/test_torch_cost_volume.py (the plane
sweep against JAX), so that every port test file stays behind
tests/test_train_step.py in pytest-xdist's file queue.
"""

import numpy as np
import pytest
import torch

from ppeadepth_tpu_torch import kernels
from ppeadepth_tpu_torch.kernels.cost_volume import (
    plane_sweep, plane_sweep_plain)
from tests.test_torch_cost_volume import (
    B, D, H, W, _K, _bins, _features, _pose, _proj, _to_torch)
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)


def test_plane_sweep_routes_cpu_to_plain():
    """CPU tensors take the plain version and launch nothing; the output
    is [B, D, H, W] f32."""
    rng = np.random.RandomState(8)
    cur, lk = _features(9)
    A, t = _proj(np.stack([_pose(rng) for _ in range(B)]), *_K())
    args = (_to_torch(cur), _to_torch(lk), torch.from_numpy(A),
            torch.from_numpy(t), torch.from_numpy(_bins()))
    before = dict(kernels.launch_counts)
    got = plane_sweep(*args)
    assert kernels.launch_counts == before
    torch.testing.assert_close(got, plane_sweep_plain(*args), rtol=0, atol=0)
    assert got.shape == (B, D, H, W) and got.dtype == torch.float32


def _args(**kw):
    cur = torch.zeros(2, 16, 6, 8).contiguous(memory_format=torch.channels_last)
    a = dict(cur=cur, lk=cur.clone(), A=torch.zeros(2, 3, 3), t=torch.zeros(2, 3),
             bins=torch.ones(4))
    a.update(kw)
    return a


@pytest.mark.parametrize("kw,exc", [
    (dict(lk=torch.zeros(2, 16, 6, 9)), ValueError),
    (dict(A=torch.zeros(2, 4, 4)), ValueError),
    (dict(t=torch.zeros(3, 3)), ValueError),
    (dict(bins=torch.ones(2, 2)), ValueError),
    (dict(cur=_args()["cur"].double(), lk=_args()["cur"].double()), TypeError),
    (dict(lk=_args()["cur"].bfloat16()), TypeError),
    (dict(A=torch.zeros(2, 3, 3, dtype=torch.float64)), TypeError),
    (dict(cur=torch.zeros(2, 16, 6, 8), lk=torch.zeros(2, 16, 6, 8)), ValueError),
])
def test_plane_sweep_rejects_bad_inputs(kw, exc):
    with pytest.raises(exc):
        plane_sweep(**_args(**kw))
