"""Dataset configurations for ScanNet and SUN RGB-D.

Counterpart of ``iou3dmatch_tpu/data/config.py``: the NumPy helpers of
the host-side eval path, and ``class2size_tensor`` / ``class2angle_tensor``,
the tensor twins of ``class2size_jnp`` / ``class2angle_jnp`` that the
losses use on the device. Mirrors
`scannet/model_util_scannet.py:19-83` and
`sunrgbd/model_util_sunrgbd.py:19-129`.

The ScanNet mean sizes are the dataset statistics shipped as
`scannet/meta_data/scannet_means.npz` in the reference, inlined here.

The tensor helpers import torch when called: the data loader's worker
processes import this module through the datasets and do NumPy work only.
"""
from __future__ import annotations

import numpy as np

_SCANNET_MEAN_SIZES = np.array(
    [
        [0.7696672604054122, 0.8116021117472902, 0.9257374136145354],
        [1.8768580001697206, 1.842559515802484, 1.1931565443674723],
        [0.6132799886259447, 0.6148608680507913, 0.7182701427611315],
        [1.3955006289669847, 1.5121545143953459, 0.8344356450508899],
        [0.9794959591575039, 1.067514848627126, 0.6329687451853335],
        [0.5316630050523676, 0.5955577157376698, 1.7500148278367265],
        [0.9624705646410668, 0.724623255389463, 1.1481868198746867],
        [0.8322192367698465, 1.0490935469312328, 1.6875663369894027],
        [0.21132214086709308, 0.4206159026354871, 0.5372845894025259],
        [1.444007275463308, 1.897083342075348, 0.2698574721523859],
        [1.0294261633133401, 1.4040796643617202, 0.875543219276837],
        [1.3766411551957802, 0.6552179310711618, 1.6813129177564903],
        [0.665081893931554, 0.7111192617003478, 1.298853067379424],
        [0.41999173755044333, 0.3790694684595675, 1.7513971522047713],
        [0.5935955854113569, 0.5912492439611671, 0.7391901372634259],
        [0.5086759479906277, 0.506560866579865, 0.30136235530383004],
        [1.151152646430185, 1.054629599379602, 0.4970679366700003],
        [0.47535286277763605, 0.492494933218611, 0.5802116805268812],
    ]
)

_SUNRGBD_TYPE_MEAN_SIZE = {
    "bed": [2.114256, 1.620300, 0.927272],
    "table": [0.791118, 1.279516, 0.718182],
    "sofa": [0.923508, 1.867419, 0.845495],
    "chair": [0.591958, 0.552978, 0.827272],
    "toilet": [0.699104, 0.454178, 0.756250],
    "desk": [0.695190, 1.346299, 0.736364],
    "dresser": [0.528526, 1.002642, 1.172878],
    "night_stand": [0.500618, 0.632163, 0.683424],
    "bookshelf": [0.404671, 1.071108, 1.688889],
    "bathtub": [0.765840, 1.398258, 0.472728],
}


class _BaseConfig:
    """Shared class2size / angle-bin logic."""

    def class2size(self, pred_cls, residual):
        """NumPy host-side (model_util_*.py class2size)."""
        return self.mean_size_arr[pred_cls, :] + residual

    def size2class(self, size, type_name):
        """Full box size -> (size class, residual); size clusters are
        semantic classes in both datasets (model_util_sunrgbd.py:80-84,
        model_util_scannet.py:56-60)."""
        size_class = self.type2class[type_name]
        return size_class, size - self.mean_size_arr[size_class]

    def mean_size_tensor(self, device) -> torch.Tensor:
        """``mean_size_arr`` as f32 on ``device``, copied there once and
        kept: a copy to the card waits for the work queued before it."""
        import torch

        cache = self.__dict__.setdefault("_mean_size_on", {})
        device = torch.device(device)
        if device not in cache:
            cache[device] = torch.as_tensor(self.mean_size_arr, dtype=torch.float32, device=device)
        return cache[device]

    def class2size_tensor(self, pred_cls: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        """Mean size of each class plus the residual, on the residual's device."""
        return self.mean_size_tensor(residual.device)[pred_cls] + residual

    def param2obb(self, center, heading_class, heading_residual, size_class, size_residual):
        heading_angle = self.class2angle(heading_class, heading_residual)
        box_size = self.class2size(int(size_class), size_residual)
        obb = np.zeros((7,))
        obb[0:3] = center
        obb[3:6] = box_size
        obb[6] = heading_angle * -1
        return obb


class ScannetConfig(_BaseConfig):
    """18 classes, 1 heading bin (axis-aligned boxes), 18 size clusters
    (scannet/model_util_scannet.py:19-83)."""

    num_class = 18
    num_heading_bin = 1
    num_size_cluster = 18
    max_num_obj = 64

    type2class = {
        "cabinet": 0, "bed": 1, "chair": 2, "sofa": 3, "table": 4, "door": 5,
        "window": 6, "bookshelf": 7, "picture": 8, "counter": 9, "desk": 10,
        "curtain": 11, "refrigerator": 12, "showercurtrain": 13, "toilet": 14,
        "sink": 15, "bathtub": 16, "garbagebin": 17,
    }
    nyu40ids = np.array(
        [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39]
    )

    def __init__(self):
        self.class2type = {v: k for k, v in self.type2class.items()}
        self.nyu40id2class = {nid: i for i, nid in enumerate(list(self.nyu40ids))}
        self.mean_size_arr = _SCANNET_MEAN_SIZES.copy()

    def class2angle(self, pred_cls, residual, to_label_format=True):
        return np.zeros(np.asarray(pred_cls).shape)

    def class2angle_tensor(self, pred_cls, residual):
        import torch

        return torch.zeros(pred_cls.shape, dtype=torch.float32, device=pred_cls.device)

    def angle2class_tensor(self, angle):
        raise NotImplementedError("ScanNet boxes are axis-aligned")


class SunrgbdConfig(_BaseConfig):
    """10 classes, 12 heading bins, 10 size clusters
    (sunrgbd/model_util_sunrgbd.py:19-129)."""

    num_class = 10
    num_heading_bin = 12
    num_size_cluster = 10
    max_num_obj = 64

    type2class = {
        "bed": 0, "table": 1, "sofa": 2, "chair": 3, "toilet": 4,
        "desk": 5, "dresser": 6, "night_stand": 7, "bookshelf": 8, "bathtub": 9,
    }

    def __init__(self):
        self.class2type = {v: k for k, v in self.type2class.items()}
        self.mean_size_arr = np.zeros((self.num_size_cluster, 3))
        for i in range(self.num_size_cluster):
            self.mean_size_arr[i, :] = _SUNRGBD_TYPE_MEAN_SIZE[self.class2type[i]]

    def class2angle(self, pred_cls, residual, to_label_format=True):
        angle_per_class = 2 * np.pi / float(self.num_heading_bin)
        angle = pred_cls * angle_per_class + residual
        if to_label_format:
            angle = angle - 2 * np.pi * (angle > np.pi)
        return angle

    def class2angle_tensor(self, pred_cls, residual):
        """Heading of a bin and residual, in (-pi, pi]."""
        angle = pred_cls.float() * (2 * np.pi / float(self.num_heading_bin)) + residual
        return angle - 2 * np.pi * (angle > np.pi).float()

    def angle2class(self, angle):
        angle_per_class = 2 * np.pi / float(self.num_heading_bin)
        angle = angle % (2 * np.pi)
        shifted = (angle + angle_per_class / 2) % (2 * np.pi)
        class_id = int(shifted / angle_per_class)
        residual = shifted - (class_id * angle_per_class + angle_per_class / 2)
        return class_id, residual

    def angle2class_tensor(self, angle: torch.Tensor):
        """Headings -> (int32 bin, residual from the bin's center)
        (sunrgbd/model_util_sunrgbd.py:62-78), elementwise."""
        import torch

        angle_per_class = 2 * np.pi / float(self.num_heading_bin)
        shifted = torch.remainder(torch.remainder(angle, 2 * np.pi) + angle_per_class / 2,
                                  2 * np.pi)
        class_id = (shifted / angle_per_class).to(torch.int32)
        return class_id, shifted - (class_id.float() * angle_per_class + angle_per_class / 2)


def get_config(dataset: str):
    if dataset == "scannet":
        return ScannetConfig()
    if dataset == "sunrgbd":
        return SunrgbdConfig()
    raise ValueError(f"unknown dataset {dataset!r}")
