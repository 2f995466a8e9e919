"""KITTI data for the port (JAX counterpart: ppeadepth_tpu/data).

`DATASETS` maps `--dataset` names to dataset classes. The CityScapes and
DDAD datasets belong to stage 2 and DDAD evaluation, which are not ported
yet: their entries raise."""

from .kitti import (  # noqa: F401
    KITTIDataset,
    KITTIDepthDataset,
    KITTIOdomDataset,
    KITTIRAWDataset,
)
from .loader import DataLoader, device_prefetch  # noqa: F401
from .mono_dataset import MonoDataset  # noqa: F401


def _not_ported(name: str, slice_name: str):
    def make(*args, **kwargs):
        raise NotImplementedError(
            f"the {name} dataset is not ported yet; it comes with the "
            f"{slice_name} slice")
    return make


DATASETS = {
    "kitti": KITTIRAWDataset,
    "kitti_odom": KITTIOdomDataset,
    "cityscapes_preprocessed": _not_ported(
        "cityscapes_preprocessed", "stage-2 (--train_cs, --dc)"),
    "cityscapes_eval": _not_ported(
        "cityscapes_eval", "stage-2 (--train_cs, --dc)"),
    "ddad": _not_ported("ddad", "DDAD evaluation (--ddad)"),
}
