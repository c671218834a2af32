"""The paper's CNN applied to CIFAR-10-shaped input (32x32x3), 10 classes."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="cnn-cifar10",
    family="toy",
    source="FedVeca paper §IV-A2",
    input_shape=(32, 32, 3),
    num_classes=10,
    param_dtype="float32",
    compute_dtype="float32",
)
