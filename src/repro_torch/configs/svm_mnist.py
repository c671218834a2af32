"""The paper's squared-SVM: fully-connected binary (even/odd) classifier on
28x28 MNIST-shaped inputs, squared-hinge loss. Satisfies Assumption 1
(convex, Lipschitz-smooth) — the model the paper uses for its main analysis.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="svm-mnist",
    family="toy",
    source="FedVeca paper §IV-A2",
    input_shape=(784,),
    num_classes=2,
    param_dtype="float32",
    compute_dtype="float32",
)
