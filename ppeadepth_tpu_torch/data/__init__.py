"""The port's data (JAX counterpart: ppeadepth_tpu/data): KITTI and
CityScapes datasets, the loader and the device prefetch.

`DATASETS` maps `--dataset` names to dataset classes. The DDAD dataset
belongs to DDAD evaluation, which is not ported yet: its entry raises."""

from .cityscapes import (  # noqa: F401
    CityscapesEvalDataset,
    CityscapesPreprocessedDataset,
)
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
    "cityscapes_preprocessed": CityscapesPreprocessedDataset,
    "cityscapes_eval": CityscapesEvalDataset,
    "ddad": _not_ported("ddad", "DDAD evaluation (--ddad)"),
}
