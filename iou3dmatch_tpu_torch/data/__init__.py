"""Data layer: dataset configs, datasets, synthetic scenes and the host-side
loader, all NumPy.

``staging.py``, which moves a batch to the card, is torch and is not
imported here: the loader's worker processes import this package.
"""
from .config import ScannetConfig, SunrgbdConfig, get_config
from .loader import DataLoader, SSLBatcher, collate, prefetch
from .synthetic import SyntheticDataset

__all__ = ["DataLoader", "SSLBatcher", "ScannetConfig", "SunrgbdConfig", "SyntheticDataset",
           "collate", "get_config", "prefetch"]
