"""The paper's own model (§5.1): permutation-invariant SVHN MLP,
4 hidden layers × 2048 ReLU units, softmax over 10 digits."""
import dataclasses

from repro_torch.models.mlp import MLPConfig

CONFIG = MLPConfig(
    name="mlp_svhn",
    input_dim=3072,
    num_classes=10,
    hidden=(2048, 2048, 2048, 2048),
)


def smoke() -> MLPConfig:
    return dataclasses.replace(CONFIG, name="mlp_svhn-smoke",
                               input_dim=64, hidden=(128, 128))
