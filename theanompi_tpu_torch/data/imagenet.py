"""ImageNet data spec for serving.

Counterpart of ``theanompi_tpu/data/imagenet.py``: the normalization
constants, the class count, the sample shape and the eval
``device_transform`` that a served request goes through.  Shard reading
and the training streams come with training.
"""

from __future__ import annotations

from theanompi_tpu_torch.ops.augment import make_device_augment

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class ImageNet_data:
    """Requests are raw uint8 NHWC images at least ``crop`` on a side;
    the device center-crops and normalizes them (``device_transform``)."""

    def __init__(self, crop: int = 224, n_classes: int = 1000):
        self.crop = int(crop)
        self.n_classes = int(n_classes)
        self.sample_shape = (self.crop, self.crop, 3)
        #: the dtype requests arrive in (raw store images)
        self.sample_dtype = "uint8"
        self.device_transform = make_device_augment(
            self.crop, mean=IMAGENET_MEAN, std=IMAGENET_STD)
