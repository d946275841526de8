"""The port's datasets against the JAX package's, on the CPU.

Every ``__getitem__`` of the port's ScanNet and SUN RGB-D datasets, after
the same ``np.random.seed``, equals the JAX one's bit for bit: the same
keys, dtypes, shapes and bytes. The dumps are ``tests/data_cases.py``'s,
written once in a temporary directory: ScanNet's three datasets with
augmentation on and off, with and without colour and height, the unlabeled
one with and without ``load_labels``; SUN RGB-D's three (the supervised one
with and without a labeled list) on the v1 and v2 dirs. Also
``SyntheticDataset`` in every mode, ``ply`` on binary and ASCII files,
``pc_util``'s rotations, and ``build_supervised_datasets`` /
``build_ssl_datasets`` for both datasets and ``--synthetic``.
"""
import types

import numpy as np
import pytest

from iou3dmatch_tpu.cli import common as jax_common
from iou3dmatch_tpu.data import pc_util as jax_pc_util
from iou3dmatch_tpu.data import ply as jax_ply
from iou3dmatch_tpu.data import scannet as jax_scannet
from iou3dmatch_tpu.data import sunrgbd as jax_sunrgbd
from iou3dmatch_tpu.data import synthetic as jax_synthetic

from data_cases import write_scannet_dump, write_sunrgbd_dump
from iou3dmatch_tpu_torch.cli import common as port_common
from iou3dmatch_tpu_torch.data import pc_util as port_pc_util
from iou3dmatch_tpu_torch.data import ply as port_ply
from iou3dmatch_tpu_torch.data import scannet as port_scannet
from iou3dmatch_tpu_torch.data import sunrgbd as port_sunrgbd
from iou3dmatch_tpu_torch.data import synthetic as port_synthetic

FEATURES = [(False, False), (False, True), (True, False), (True, True)]  # (colour, height)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("dumps")
    write_scannet_dump(root)
    write_sunrgbd_dump(root)
    return root


def assert_same_sample(got, want):
    assert list(got) == list(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert (g.dtype, g.shape) == (w.dtype, w.shape), k
        assert g.tobytes() == w.tobytes(), k


def assert_same_items(port_ds, jax_ds):
    assert type(port_ds).__name__ == type(jax_ds).__name__
    assert len(port_ds) == len(jax_ds) > 0
    assert getattr(port_ds, "scan_names", None) == getattr(jax_ds, "scan_names", None)
    for i in range(len(port_ds)):
        np.random.seed(100 + i)
        got = port_ds[i]
        np.random.seed(100 + i)
        want = jax_ds[i]
        assert_same_sample(got, want)


SCANNET = {
    "detection": lambda m, d, s, **kw: m.ScannetDetectionDataset(d, s, "train", **kw),
    "detection_labeled": lambda m, d, s, **kw: m.ScannetDetectionDataset(
        d, s, "train", labeled_sample_list="labeled.txt", **kw),
    "detection_val": lambda m, d, s, **kw: m.ScannetDetectionDataset(d, s, "val", **kw),
    "ssl_labeled": lambda m, d, s, **kw: m.ScannetSSLLabeledDataset(d, s, "labeled.txt", **kw),
    "ssl_unlabeled": lambda m, d, s, **kw: m.ScannetSSLUnlabeledDataset(
        d, s, "labeled.txt", **kw),
    "ssl_unlabeled_labels": lambda m, d, s, **kw: m.ScannetSSLUnlabeledDataset(
        d, s, "labeled.txt", load_labels=True, **kw),
}


@pytest.mark.parametrize("features", FEATURES)
@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("kind", SCANNET)
def test_scannet_datasets_match_jax(root, kind, augment, features):
    d, s = str(root / "scannet_train_detection_data"), str(root / "meta_data")
    kw = dict(num_points=2048, use_color=features[0], use_height=features[1], augment=augment)
    assert_same_items(SCANNET[kind](port_scannet, d, s, **kw),
                      SCANNET[kind](jax_scannet, d, s, **kw))


def test_scannet_dataset_samples_with_replacement_past_the_scan(root):
    """More points asked than the scan holds: sampling with replacement."""
    d = str(root / "scannet_train_detection_data")
    kw = dict(num_points=4000, use_height=True, augment=True)
    assert_same_items(port_scannet.ScannetDetectionDataset(d, split_set="all", **kw),
                      jax_scannet.ScannetDetectionDataset(d, split_set="all", **kw))


SUNRGBD = {
    "detection": lambda m, d, s, **kw: m.SunrgbdDetectionVotesDataset(d, **kw),
    "detection_labeled": lambda m, d, s, **kw: m.SunrgbdDetectionVotesDataset(
        d, s, labeled_sample_list="labeled.txt", **kw),
    "ssl_labeled": lambda m, d, s, **kw: m.SunrgbdSSLLabeledDataset(d, s, "labeled.txt", **kw),
    "ssl_unlabeled": lambda m, d, s, **kw: m.SunrgbdSSLUnlabeledDataset(
        d, s, "labeled.txt", **kw),
    "ssl_unlabeled_labels": lambda m, d, s, **kw: m.SunrgbdSSLUnlabeledDataset(
        d, s, "labeled.txt", load_labels=True, **kw),
}


@pytest.mark.parametrize("features", FEATURES)
@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("version", ["v1", "v2"])
@pytest.mark.parametrize("kind", SUNRGBD)
def test_sunrgbd_datasets_match_jax(root, kind, version, augment, features):
    d = str(root / f"sunrgbd_pc_bbox_votes_50k_{version}_train")
    s = str(root / "sunrgbd_trainval")
    kw = dict(num_points=2048, use_color=features[0], use_height=features[1], augment=augment)
    assert_same_items(SUNRGBD[kind](port_sunrgbd, d, s, **kw),
                      SUNRGBD[kind](jax_sunrgbd, d, s, **kw))


SYNTHETIC = [
    dict(),
    dict(dataset="sunrgbd"),
    dict(ssl=True),
    dict(ssl=True, labeled=False),
    dict(ssl=True, labeled=False, load_labels=True),
    dict(dataset="sunrgbd", ssl=True, labeled=False, load_labels=True, seed=3),
]


@pytest.mark.parametrize("kw", SYNTHETIC, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_synthetic_dataset_matches_jax(kw):
    assert_same_items(port_synthetic.SyntheticDataset(num_scenes=3, num_points=1024, **kw),
                      jax_synthetic.SyntheticDataset(num_scenes=3, num_points=1024, **kw))


def _write_ply(path, fmt, verts, colors):
    n = len(verts)
    header = [b"ply", f"format {fmt} 1.0".encode(), b"comment a faceless mesh",
              f"element vertex {n}".encode(), b"property float x", b"property float y",
              b"property float z", b"property uchar red", b"property uchar green",
              b"property uchar blue", b"property uchar alpha", b"element face 0",
              b"property list uchar int vertex_indices", b"end_header"]
    with open(path, "wb") as f:
        f.write(b"\n".join(header) + b"\n")
        if fmt == "ascii":
            for v, c in zip(verts, colors):
                f.write((" ".join(f"{x:.6f}" for x in v) + " "
                         + " ".join(str(x) for x in c) + "\n").encode())
        else:
            rec = np.zeros(n, np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("red", "u1"),
                                        ("green", "u1"), ("blue", "u1"), ("alpha", "u1")]))
            for i, name in enumerate("xyz"):
                rec[name] = verts[:, i]
            for i, name in enumerate(("red", "green", "blue", "alpha")):
                rec[name] = colors[:, i]
            f.write(rec.tobytes())


@pytest.mark.parametrize("fmt", ["binary_little_endian", "ascii"])
def test_ply_readers_match_jax(tmp_path, fmt):
    rng = np.random.RandomState(4)
    verts = rng.uniform(-3, 3, (257, 3)).astype(np.float32)
    colors = rng.randint(0, 256, (257, 4)).astype(np.uint8)
    path = str(tmp_path / "mesh.ply")
    _write_ply(path, fmt, verts, colors)
    for name in ("read_ply_vertices", "read_mesh_vertices", "read_mesh_vertices_rgb"):
        got, want = getattr(port_ply, name)(path), getattr(jax_ply, name)(path)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), name
    np.testing.assert_allclose(port_ply.read_mesh_vertices(path), verts, atol=1e-6)
    with pytest.raises(ValueError, match="not a ply file"):
        (tmp_path / "bad.ply").write_bytes(b"plx\n")
        port_ply.read_ply_vertices(str(tmp_path / "bad.ply"))


def test_pc_util_matches_jax():
    for t in (-np.pi, -0.3, 0.0, 0.7, 2.5):
        for name in ("rotz", "roty"):
            got, want = getattr(port_pc_util, name)(t), getattr(jax_pc_util, name)(t)
            assert got.tobytes() == want.tobytes(), name
    pc = np.arange(60, dtype=np.float32).reshape(20, 3)
    for n in (5, 20, 40):
        np.random.seed(n)
        got = port_pc_util.random_sampling(pc, n, return_choices=True)
        np.random.seed(n)
        want = jax_pc_util.random_sampling(pc, n, return_choices=True)
        for g, w in zip(got, want):
            assert g.tobytes() == w.tobytes()


def _args(root, dataset, **kw):
    base = dict(dataset=dataset, data_path=str(root), labeled_sample_list="labeled.txt",
                num_point=2048, no_height=False, use_color=False, use_sunrgbd_v2=False,
                synthetic=False, synthetic_scenes=8, view_stats=True)
    base.update(kw)
    return types.SimpleNamespace(**base)


BUILDS = {
    "scannet": dict(dataset="scannet"),
    "scannet_colour_no_height": dict(dataset="scannet", use_color=True, no_height=True),
    "sunrgbd_v1": dict(dataset="sunrgbd"),
    "sunrgbd_v2": dict(dataset="sunrgbd", use_sunrgbd_v2=True),
    "synthetic_scannet": dict(dataset="scannet", synthetic=True, num_point=1024),
    "synthetic_sunrgbd": dict(dataset="sunrgbd", synthetic=True, num_point=1024),
    "no_view_stats": dict(dataset="scannet", view_stats=False),
}


@pytest.mark.parametrize("stage", ["supervised", "ssl"])
@pytest.mark.parametrize("build", BUILDS)
def test_dataset_builders_match_jax(root, build, stage):
    args = _args(root, **BUILDS[build])
    fn = f"build_{stage}_datasets"
    got, want = getattr(port_common, fn)(args), getattr(jax_common, fn)(args)
    assert len(got) == len(want)
    assert got[-1].num_class == want[-1].num_class
    for port_ds, jax_ds in zip(got[:-1], want[:-1]):
        for name in ("num_points", "use_color", "use_height", "augment", "load_labels",
                     "data_path"):
            assert getattr(port_ds, name, None) == getattr(jax_ds, name, None), name
        assert_same_items(port_ds, jax_ds)
