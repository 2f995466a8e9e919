"""The port's data (JAX counterpart: ppeadepth_tpu/data): KITTI,
CityScapes and DDAD datasets, the loader and the device prefetch.

`DATASETS` maps `--dataset` names to dataset classes."""

from .cityscapes import (  # noqa: F401
    CityscapesEvalDataset,
    CityscapesPreprocessedDataset,
)
from .ddad import DDADNpzDataset  # noqa: F401
from .kitti import (  # noqa: F401
    KITTIDataset,
    KITTIDepthDataset,
    KITTIOdomDataset,
    KITTIRAWDataset,
)
from .loader import DataLoader, device_prefetch  # noqa: F401
from .mono_dataset import MonoDataset  # noqa: F401

DATASETS = {
    "kitti": KITTIRAWDataset,
    "kitti_odom": KITTIOdomDataset,
    "cityscapes_preprocessed": CityscapesPreprocessedDataset,
    "cityscapes_eval": CityscapesEvalDataset,
    "ddad": DDADNpzDataset,
}
