"""The port's package rules, weight bridge and host-side helpers.

- Weights: ``state_dict_from_jax`` and the JAX package's
  ``export_state_dict`` both load strictly into the port's model and agree
  leaf for leaf; the importer refuses what it cannot place.
- Imports: no module of ``iou3dmatch_tpu_torch`` and not ``chip_smoke.py``
  imports jax, flax, optax or iou3dmatch_tpu (a source scan: this image may
  import jax at interpreter start, so ``sys.modules`` proves nothing).
- Devices: entry points refuse to drop to the CPU unasked.
- The NumPy copies (config, boxes, NMS, parse_predictions) against the JAX
  package's on the same seeded inputs.
"""
import ast
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from iou3dmatch_tpu_torch.models.factory import build_votenet  # noqa: E402
from iou3dmatch_tpu_torch.train.torch_import import state_dict_from_jax  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_variables():
    from iou3dmatch_tpu.models.factory import build_votenet as build_jax

    jm, _ = build_jax("scannet", tiny=True)
    pc = np.random.RandomState(0).uniform(-3, 3, (1, 2048, 4)).astype(np.float32)
    variables = jax.jit(lambda x: jm.init({"params": jax.random.PRNGKey(1)}, x, train=False))(
        jnp.asarray(pc))
    return jax.tree.map(np.asarray, dict(variables))


def test_state_dict_from_jax_and_export_both_load_strictly(jax_variables):
    from iou3dmatch_tpu.train.torch_import import export_state_dict

    model, _ = build_votenet("scannet", tiny=True, device="cpu")
    ours = state_dict_from_jax(jax_variables)
    exported = {k: torch.from_numpy(np.array(v)) for k, v in export_state_dict(jax_variables).items()}
    assert set(ours) == set(exported) == set(model.state_dict())
    for k in ours:
        assert torch.equal(ours[k], exported[k]), k
    model.load_state_dict(ours, strict=True)
    model.load_state_dict(exported, strict=True)
    assert model.state_dict()["backbone_net.sa1.mlp_module.layer0.conv.weight"].shape == (64, 4, 1, 1)
    assert model.state_dict()["vgen.conv1.weight"].shape == (256, 256, 1)
    assert "vgen.bn1.running_mean" in ours


def test_state_dict_from_jax_refuses_what_it_cannot_place(jax_variables):
    def with_leaf(coll, path, value):
        tree = {"params": dict(jax_variables["params"]),
                "batch_stats": dict(jax_variables["batch_stats"])}
        node = tree[coll]
        for p in path[:-1]:
            node[p] = dict(node[p])
            node = node[p]
        node[path[-1]] = value
        return tree

    with pytest.raises(KeyError, match="no destination"):
        state_dict_from_jax(with_leaf("params", ("vgen", "conv1", "gamma"), np.zeros(3)))
    with pytest.raises(KeyError, match="SharedMLP bias"):
        state_dict_from_jax(with_leaf(
            "params", ("backbone_net", "sa1", "mlp", "dense0", "bias"), np.zeros(64)))
    with pytest.raises(ValueError, match="2-D"):
        state_dict_from_jax(with_leaf("params", ("vgen", "conv1", "kernel"), np.zeros((2, 2, 2))))
    model, _ = build_votenet("scannet", tiny=True, device="cpu")
    bad = state_dict_from_jax(with_leaf("params", ("vgen", "conv1", "kernel"), np.zeros((3, 5))))
    with pytest.raises(RuntimeError, match="size mismatch"):
        model.load_state_dict(bad, strict=True)


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax_and_nothing_of_the_jax_package():
    files = sorted((ROOT / "iou3dmatch_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    banned = ("jax", "jaxlib", "flax", "optax", "iou3dmatch_tpu")
    bad = [(f.relative_to(ROOT), m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in banned]
    assert not bad, bad


def test_build_votenet_without_cuda_and_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_votenet()
    model, cfg = build_votenet(tiny=True, device="cpu")
    assert next(model.parameters()).device.type == "cpu" and not model.training


def test_batchnorm_refuses_training_mode():
    """Train mode refuses to run until the schedule has set a momentum."""
    from iou3dmatch_tpu_torch.models.mlp import BatchNorm, set_bn_momentum

    bn = BatchNorm(4).train()
    with pytest.raises(RuntimeError, match="set_bn_momentum"):
        bn(torch.zeros(2, 4))
    set_bn_momentum(bn, 0.5)
    assert torch.equal(bn(torch.ones(2, 4)), torch.zeros(2, 4))
    assert torch.equal(bn.running_mean, torch.full((4,), 0.5))


def test_one_seed_gives_one_model():
    a, _ = build_votenet(tiny=True, device="cpu", generator=torch.Generator().manual_seed(3))
    b, _ = build_votenet(tiny=True, device="cpu", generator=torch.Generator().manual_seed(3))
    c, _ = build_votenet(tiny=True, device="cpu", generator=torch.Generator().manual_seed(4))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["vgen.conv1.weight"], sc["vgen.conv1.weight"])


def test_kernel_build_is_lazy_and_keyed_by_source():
    """Importing the ops builds nothing; a library's name carries a hash of
    its source and flags, under build/kernels at the repository root."""
    from iou3dmatch_tpu_torch.ops import _build

    assert not _build._libs
    for name in _build.SOURCES:
        path = _build.library_path(name)
        assert path.parent == ROOT / "build" / "kernels"
        assert path.name.startswith(name + "-") and path.suffix == ".so"
        assert (_build.CSRC / f"{name}.cu").exists()


@pytest.mark.parametrize("dataset", ["scannet", "sunrgbd"])
def test_config_matches_jax(dataset):
    from iou3dmatch_tpu.data.config import get_config as jax_config

    from iou3dmatch_tpu_torch.data.config import get_config

    a, b = get_config(dataset), jax_config(dataset)
    np.testing.assert_array_equal(a.mean_size_arr, b.mean_size_arr)
    assert (a.num_class, a.num_heading_bin, a.num_size_cluster) == \
        (b.num_class, b.num_heading_bin, b.num_size_cluster)
    cls = np.array([[0, 3, 11]]) % a.num_heading_bin
    res = np.array([[0.1, -0.2, 0.3]])
    np.testing.assert_array_equal(a.class2angle(cls, res), b.class2angle(cls, res))


def test_boxes_match_jax():
    from iou3dmatch_tpu.geometry import boxes as jb

    from iou3dmatch_tpu_torch.geometry import boxes as pb

    rng = np.random.RandomState(8)
    t = rng.uniform(-np.pi, np.pi, (3, 5)).astype(np.float32)
    np.testing.assert_allclose(pb.rot_gpu(torch.from_numpy(t)).numpy(),
                               np.asarray(jb.rot_gpu(jnp.asarray(t))), rtol=0, atol=1e-7)
    size, center = rng.uniform(0.1, 2, (3, 5, 3)), rng.uniform(-3, 3, (3, 5, 3))
    np.testing.assert_array_equal(pb.get_3d_box_batch_np(size, t.astype(np.float64), center),
                                  jb.get_3d_box_batch_np(size, t.astype(np.float64), center))
    np.testing.assert_array_equal(pb.flip_axis_to_camera(center), jb.flip_axis_to_camera(center))


def _random_ep(rng, b=2, k=48, nc=18, nh=1, ns=18):
    center = rng.uniform(-2, 2, (b, k, 3))
    center[:, k // 2:] = center[:, :k // 2] + rng.normal(0, 0.05, (b, k - k // 2, 3))  # overlaps
    return {
        "center": center.astype(np.float32),
        "heading_scores": rng.randn(b, k, nh).astype(np.float32),
        "heading_residuals": (rng.randn(b, k, nh) * 0.1).astype(np.float32),
        "size_scores": rng.randn(b, k, ns).astype(np.float32),
        "size_residuals": (rng.randn(b, k, ns, 3) * 0.1).astype(np.float32),
        "sem_cls_scores": rng.randn(b, k, nc).astype(np.float32),
        "objectness_scores": rng.randn(b, k, 2).astype(np.float32),
        "iou_scores": rng.randn(b, k, nc).astype(np.float32),
    }


@pytest.mark.parametrize("mode", ["2d", "3d", "3d_cls", "3d_cls_iou", "no_per_class"])
def test_parse_predictions_matches_jax(mode):
    """Every NMS branch of the NumPy copy picks what the JAX package's does."""
    from iou3dmatch_tpu.eval.ap_helper import parse_predictions as jax_parse

    from iou3dmatch_tpu_torch.data.config import get_config
    from iou3dmatch_tpu_torch.eval.ap_helper import eval_config_dict, parse_predictions

    config = eval_config_dict(get_config("scannet"), use_iou_for_nms=mode == "3d_cls_iou")
    config["use_3d_nms"] = mode != "2d"
    config["cls_nms"] = mode.startswith("3d_cls") or mode == "no_per_class"
    config["per_class_proposal"] = mode != "no_per_class"
    ep = _random_ep(np.random.RandomState(len(mode)))
    got = parse_predictions({k: torch.from_numpy(v) for k, v in ep.items()}, config)
    want = jax_parse(ep, config)
    assert [len(g) for g in got] == [len(w) for w in want]
    assert sum(len(g) for g in got) < 2 * 48 * (18 if config["per_class_proposal"] else 1)
    for gs, ws in zip(got, want):
        for (gc, gbox, gscore), (wc, wbox, wscore) in zip(gs, ws):
            assert gc == wc and gscore == wscore
            np.testing.assert_array_equal(gbox, wbox)


def test_parse_predictions_refuses_remove_empty_box():
    from iou3dmatch_tpu_torch.data.config import get_config
    from iou3dmatch_tpu_torch.eval.ap_helper import eval_config_dict, parse_predictions

    config = dict(eval_config_dict(get_config("scannet")), remove_empty_box=True)
    with pytest.raises(NotImplementedError):
        parse_predictions(_random_ep(np.random.RandomState(0)), config)
