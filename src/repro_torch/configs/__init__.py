from repro_torch.configs.base import ArchConfig, get_arch, list_archs

__all__ = ["ArchConfig", "get_arch", "list_archs"]
