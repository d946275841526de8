"""The scene generator: the same seed gives the same batches, another seed
other content at the same shapes, and seeds past 32 bits work."""
import numpy as np
import pytest

from harness import manifest, traffic

# each mix with its configuration; sunrgbd-eval is a cell kept as files
MIXES = {"scannet-ssl": "scannet-votenet-iou", "scannet-eval-opt": "scannet-votenet-iou",
         "sunrgbd-pretrain": "sunrgbd-votenet-iou", "sunrgbd-eval": "sunrgbd-votenet-iou"}
CELLS = tuple(MIXES)


def small(workload):
    config = dict(manifest.config(manifest.load(), MIXES[workload]), num_point=2048)
    return config, dict(manifest.mix(workload), pool=2)


@pytest.mark.parametrize("workload", CELLS)
def test_same_seed_same_batches(workload):
    config, mix = small(workload)
    a, b = traffic.batches(2**31 + 5, config, mix), traffic.batches(2**31 + 5, config, mix)
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("workload", CELLS)
def test_other_seed_same_shapes_other_content(workload):
    config, mix = small(workload)
    a, b = traffic.batches(7, config, mix)[0], traffic.batches(2**40 + 7, config, mix)[0]
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
    assert not np.array_equal(a["point_clouds"], b["point_clouds"])


@pytest.mark.parametrize("workload", CELLS)
def test_labels_match_the_scene(workload):
    config, mix = small(workload)
    batch = traffic.batches(3, config, mix)[0]
    n_boxes = batch["box_label_mask"].sum(1)
    lo, hi = mix["scene"]["boxes"]
    assert ((n_boxes >= lo) & (n_boxes <= hi)).all()
    assert batch["point_clouds"].shape[1:] == (config["num_point"], 3 + config["input_feature_dim"])
    hit = batch["vote_label_mask"].astype(bool)
    assert abs(hit.mean() - mix["scene"]["in_boxes"]) < 0.01
    votes = batch["vote_label"][hit][:, 0:3]
    np.testing.assert_array_equal(votes, batch["vote_label"][hit][:, 3:6])
    assert (batch["size_class_label"] < config["num_size_cluster"]).all()
    assert (batch["heading_class_label"] < config["num_heading_bin"]).all()
