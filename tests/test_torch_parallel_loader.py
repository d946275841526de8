"""The port's ``DataLoader(rank, world_size)`` and ``SSLBatcher`` against the
JAX loader's global batch, on the CPU.

With W = 2, rank r's loader at the per-device batch size yields the rows
``[r·b, (r+1)·b)`` of each of the JAX loader's global batches of ``b·W``,
bit for bit, over 2 epochs, with process workers (each sample seeded by
``(seed, epoch, index)``); each rank's ``SSLBatcher`` yields ``[L_r;
U_r]`` of JAX's ``SSLBatcher`` batch of ``bl·W`` labeled and ``bu·W``
unlabeled scenes, label-only keys at ``L_r``. Every rank has the JAX
loader's number of batches an epoch, and a loader over several ranks
refuses to keep a short last batch. No process group is needed: a rank's
loader reads nothing of the others.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
from iou3dmatch_tpu.data import loader as jax_loader  # noqa: E402
from iou3dmatch_tpu.data import scannet as jax_scannet  # noqa: E402

from data_cases import write_scannet_dump  # noqa: E402
from iou3dmatch_tpu_torch.data import loader as port_loader  # noqa: E402
from iou3dmatch_tpu_torch.data import scannet as port_scannet  # noqa: E402
from iou3dmatch_tpu_torch.parallel import take_rows  # noqa: E402

W = 2


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    root = write_scannet_dump(tmp_path_factory.mktemp("scannet"), n_train=10, n_val=2,
                              n_labeled=4)
    return str(root / "scannet_train_detection_data"), str(root / "meta_data")


def _ssl_datasets(module, data, split):
    kw = dict(num_points=1024, use_height=True, augment=True)
    return (module.ScannetSSLLabeledDataset(data, split, "labeled.txt", **kw),
            module.ScannetSSLUnlabeledDataset(data, split, "labeled.txt", load_labels=True,
                                              **kw))


def _rows(batch: dict, rows) -> dict:
    n = max(len(v) for v in batch.values())
    nl = min(len(v) for v in batch.values())
    return {k: v[rows if len(v) == n else [i for i in rows if i < nl]] for k, v in batch.items()}


def test_rank_loaders_yield_the_jax_global_batches_rows(dump):
    data, split = dump
    ds_port = port_scannet.ScannetDetectionDataset(data, split, "train", num_points=1024,
                                                   use_height=True, augment=True)
    ds_jax = jax_scannet.ScannetDetectionDataset(data, split, "train", num_points=1024,
                                                 use_height=True, augment=True)
    kw = dict(num_workers=2, seed=5, worker_type="process")
    ranks = [port_loader.DataLoader(ds_port, 2, rank=r, world_size=W, **kw) for r in range(W)]
    glob = jax_loader.DataLoader(ds_jax, 2 * W, **kw)
    try:
        assert [len(x) for x in ranks] == [len(glob)] * W == [2, 2]
        for _ in range(2):
            want = list(glob)
            for r, loader in enumerate(ranks):
                got = list(loader)
                assert len(got) == len(want)
                for g, w in zip(got, want):
                    assert list(g) == list(w)
                    for k in w:
                        assert g[k].tobytes() == w[k][2 * r:2 * r + 2].tobytes(), (r, k)
    finally:
        for loader in ranks + [glob]:
            loader.close()


def test_rank_ssl_batchers_yield_l_r_then_u_r_of_the_jax_batch(dump):
    bl, bu = 1, 2
    kw = dict(num_workers=2, worker_type="process")
    labeled, unlabeled = _ssl_datasets(port_scannet, *dump)
    ranks = [port_loader.SSLBatcher(
        port_loader.DataLoader(labeled, bl, seed=0, rank=r, world_size=W, **kw),
        port_loader.DataLoader(unlabeled, bu, seed=1, rank=r, world_size=W, **kw))
        for r in range(W)]
    jl, ju = _ssl_datasets(jax_scannet, *dump)
    glob = jax_loader.SSLBatcher(jax_loader.DataLoader(jl, bl * W, seed=0, **kw),
                                 jax_loader.DataLoader(ju, bu * W, seed=1, **kw))
    try:
        assert [len(b) for b in ranks] == [len(glob)] * W == [2, 2]
        for _ in range(2):
            want = list(glob)
            for r, batcher in enumerate(ranks):
                got = list(batcher)
                assert len(got) == len(want)
                for g, w in zip(got, want):
                    rows = take_rows(np.arange((bl + bu) * W), r, W, bl * W, bu * W)
                    w = _rows(w, rows)
                    assert list(g) == list(w)
                    for k in w:
                        assert (g[k].dtype, g[k].shape) == (w[k].dtype, w[k].shape), (r, k)
                        assert g[k].tobytes() == w[k].tobytes(), (r, k)
                assert got[0]["vote_label"].shape[0] == bl
                assert got[0]["point_clouds"].shape[0] == bl + bu
    finally:
        for b in ranks + [glob]:
            b.labeled_loader.close()
            b.unlabeled_loader.close()


def test_a_loader_over_ranks_drops_the_short_batch_and_checks_its_rank():
    with pytest.raises(ValueError, match="drops the last batch"):
        port_loader.DataLoader(list(range(5)), 2, drop_last=False, num_workers=0, rank=0,
                               world_size=2)
    with pytest.raises(ValueError, match="rank 2 of 2"):
        port_loader.DataLoader(list(range(5)), 2, num_workers=0, rank=2, world_size=2)
    loader = port_loader.DataLoader(list(range(9)), 2, num_workers=0, rank=1, world_size=2)
    assert len(loader) == 2  # 9 // 4
