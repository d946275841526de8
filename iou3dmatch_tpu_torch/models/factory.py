"""Model construction."""
from typing import Optional, Sequence

import torch

from ..data.config import get_config
from .groupfree import GroupFreeDetector
from .votenet import VoteNet

# Tiny geometry for CPU tests: same architecture, fewer points.
TINY_SA_NPOINTS = (128, 64, 32, 16)


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else CUDA; raises when CUDA is absent and no
    device was given, so nothing drops to the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def build_votenet(dataset: str = "scannet", num_proposal: Optional[int] = None,
                  input_feature_dim: int = 1, tiny: bool = False, device=None,
                  generator: Optional[torch.Generator] = None, sampling: str = "seed_fps",
                  vote_factor: int = 1, query_feats: str = "seed", fps_prefix: bool = True,
                  compute_dtype=None, f32_gridconv: bool = False):
    """Returns (model in eval mode on ``device``, dataset config). Defaults
    mirror the JAX ``build_votenet`` (``models/factory.py:9-44``):
    num_proposal 128, or 16 when tiny; ``seed_fps`` sampling, one vote a
    seed; GridConv on the seeds (``query_feats`` "seed", "vote" or
    "seed+vote"); ``fps_prefix`` True skips the FPS of SA2-SA4 and
    ``seed_fps``, whose inputs are FPS-ordered, False runs it (the same
    outputs). No driver sets these two, as in JAX. ``compute_dtype``
    "bfloat16" is the drivers' ``--bf16``, with
    ``f32_gridconv`` their ``--f32_gridconv`` (``models/votenet.py``); the
    parameters stay f32, so one state dict serves both dtypes.

    Weights are drawn on the CPU from ``generator`` (seed 0 when None) and
    then moved, so one seed gives the same model on every device. On CUDA,
    float32 means float32: TF32 is switched off for matmuls and cuDNN; and
    a bf16 product accumulates in f32, as JAX's: cuBLAS's reduced-precision
    bf16 reductions are switched off."""
    if not isinstance(fps_prefix, bool):
        raise ValueError(f"fps_prefix is True or False, not {fps_prefix!r}")
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    cfg = get_config(dataset)
    model = VoteNet(
        num_class=cfg.num_class, num_heading_bin=cfg.num_heading_bin,
        num_size_cluster=cfg.num_size_cluster, mean_size_arr=cfg.mean_size_arr,
        generator=generator, input_feature_dim=input_feature_dim,
        num_proposal=num_proposal or (16 if tiny else 128), vote_factor=vote_factor,
        sa_npoints=TINY_SA_NPOINTS if tiny else (2048, 1024, 512, 256), sampling=sampling,
        query_feats=query_feats, fps_prefix=fps_prefix, compute_dtype=compute_dtype,
        f32_gridconv=f32_gridconv)
    return _placed(model, device), cfg


def _placed(model, device: torch.device):
    """``model`` in eval mode on ``device``; on CUDA with TF32 off and bf16
    products accumulated in f32."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return model.to(device).eval()


def build_groupfree(dataset: str = "scannet", num_proposal: Optional[int] = None,
                    num_decoder_layers: int = 12, width: int = 2, input_feature_dim: int = 1,
                    tiny: bool = False, device=None,
                    generator: Optional[torch.Generator] = None,
                    sa_npoints: Optional[Sequence[int]] = None):
    """Returns (Group-Free-3D with the IoU branch, ``models/groupfree.py``,
    in eval mode on ``device``, dataset config). Defaults are the release's
    largest ScanNet model, L12-O256-w2x: 256 queries (16 when tiny), 12
    decoder layers, width 2. ``sa_npoints`` defaults to VoteNet's SA
    centers (the tiny ones when tiny). Weights and device as
    ``build_votenet``."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    cfg = get_config(dataset)
    model = GroupFreeDetector(
        num_class=cfg.num_class, num_heading_bin=cfg.num_heading_bin,
        num_size_cluster=cfg.num_size_cluster, mean_size_arr=cfg.mean_size_arr,
        generator=generator, input_feature_dim=input_feature_dim, width=width,
        num_proposal=num_proposal or (16 if tiny else 256),
        num_decoder_layers=num_decoder_layers,
        sa_npoints=sa_npoints or (TINY_SA_NPOINTS if tiny else (2048, 1024, 512, 256)))
    return _placed(model, device), cfg
