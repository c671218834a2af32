"""The paper's CNN (footnote 2): two 5x5x32 conv + two 2x2 maxpool,
fc 1568->256, fc 256->10, softmax. Non-convex (used to probe Assumption 1
violation in §IV-B1). MNIST-shaped input.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="cnn-mnist",
    family="toy",
    source="FedVeca paper §IV-A2 footnote 2",
    input_shape=(28, 28, 1),
    num_classes=10,
    param_dtype="float32",
    compute_dtype="float32",
)
