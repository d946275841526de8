"""The system under test, ``iou3dmatch_tpu_torch``, built from a
configuration file and loaded with the benchmark's weights. This is the
only module of the harness that imports the port."""
import numpy as np

from . import weights

# The settings both sides run, the port and the plain reference alike: the
# port's defaults. A configuration states them; one that states another
# value is refused, since neither side would run it.
RUN_AS = {"cluster_sampling": "seed_fps", "vote_factor": 1, "precision": "float32",
          "tf32": False}


def check_run_as(config: dict) -> None:
    """Raises where the file asks for a setting that the benchmark does not run."""
    for key, value in RUN_AS.items():
        if config[key] != value:
            raise ValueError(f"{key}: the benchmark runs {value!r}, the file asks for "
                             f"{config[key]!r}")


def check_config(config: dict, cfg) -> None:
    """Raises where the port's dataset config disagrees with the file."""
    for key in ("num_class", "num_heading_bin", "num_size_cluster", "max_num_obj"):
        if getattr(cfg, key) != config[key]:
            raise ValueError(f"{key}: the port has {getattr(cfg, key)}, the file {config[key]}")
    if not np.array_equal(np.asarray(cfg.mean_size_arr), np.asarray(config["mean_size_arr"])):
        raise ValueError("mean_size_arr: the port's differs from the file's")


def build(config: dict, seed: int, device):
    """(model, dataset config) of the port, with the benchmark's weights of
    ``seed``, on ``device``."""
    from iou3dmatch_tpu_torch.models.factory import build_votenet

    check_run_as(config)
    model, cfg = build_votenet(config["dataset"], num_proposal=config["num_proposal"],
                               input_feature_dim=config["input_feature_dim"],
                               tiny=config.get("tiny", False), device=device)
    check_config(config, cfg)
    weights.load(model, weights.make(weights.shapes_of(model), seed, device))
    return model, cfg
