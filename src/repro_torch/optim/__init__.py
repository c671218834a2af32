from repro_torch.optim.optimizers import Optimizer, adam, momentum, sgd

__all__ = ["Optimizer", "adam", "momentum", "sgd"]
