"""The port's loader, staging and loader-fed entry points, on the CPU.

- ``DataLoader`` batches equal to the JAX loader's bit for bit over 2
  epochs, with 2 process workers (per-sample seeds) and with 1 thread
  (the global ``np.random`` stream), with ``drop_last`` on and off, and the
  same ``len``; ``SSLBatcher``'s merged batches equal to JAX's over 2
  epochs, label-only keys at the labeled count; its error on an unlabeled
  loader without batches; ``prefetch`` forwarding a producer's exception.
- Process workers that fail raise: a pool whose workers cannot start (a
  dataset that cannot be pickled to a spawned worker) at construction, a
  worker that exits at the batch. The JAX loader turns the first into
  threads.
- ``stage_batch``: on the CPU, equal to a tensor of each leaf, dtypes kept;
  without a device and without CUDA it raises; ``layout``'s offsets.
- The port's pretrain and SSL steps (tiny model, CPU) on loader batches of
  fake ScanNet dumps: the keys and shapes the JAX datasets yield are the
  ones the steps read.
- ``evaluate`` over the port's ``DataLoader`` of a fake ScanNet val dump,
  whose GT boxes sit on the model's own proposals, against the JAX
  ``evaluate`` over the JAX loader with the same weights: mAP and AR at
  0.25 and 0.5 equal, and mAP@0.25 above 0.
"""
import threading
import types
from concurrent.futures.process import BrokenProcessPool

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from iou3dmatch_tpu.data import loader as jax_loader  # noqa: E402
from iou3dmatch_tpu.data import scannet as jax_scannet  # noqa: E402

from data_cases import ExitsAt, write_scannet_dump  # noqa: E402
from iou3dmatch_tpu_torch.data import loader as port_loader  # noqa: E402
from iou3dmatch_tpu_torch.data import scannet as port_scannet  # noqa: E402
from iou3dmatch_tpu_torch.data.staging import ALIGN, layout, stage_batch  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    root = write_scannet_dump(tmp_path_factory.mktemp("scannet"), n_train=7, n_val=3)
    return str(root / "scannet_train_detection_data"), str(root / "meta_data")


def assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert (g[k].dtype, g[k].shape) == (w[k].dtype, w[k].shape), k
            assert g[k].tobytes() == w[k].tobytes(), k


def _pair(module, data, split, **kw):
    return module.ScannetDetectionDataset(data, split, "train", num_points=1024,
                                          use_height=True, augment=True, **kw)


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("worker_type,workers", [("process", 2), ("thread", 1)])
def test_dataloader_matches_jax_over_two_epochs(dump, worker_type, workers, drop_last):
    kw = dict(batch_size=3, num_workers=workers, seed=5, drop_last=drop_last,
              worker_type=worker_type)
    ours = port_loader.DataLoader(_pair(port_scannet, *dump), **kw)
    theirs = jax_loader.DataLoader(_pair(jax_scannet, *dump), **kw)
    try:
        assert theirs.worker_type == ours.worker_type == worker_type
        assert len(ours) == len(theirs) == (2 if drop_last else 3)
        for epoch in range(2):
            np.random.seed(epoch)
            got = list(ours)
            np.random.seed(epoch)
            want = list(theirs)
            assert_same_batches(got, want)
            assert got[0]["point_clouds"].shape == (3, 1024, 4)
            assert got[-1]["scan_idx"].shape == ((3,) if drop_last else (1,))
    finally:
        ours.close()
        theirs.close()


def test_epochs_differ_and_process_batches_repeat_across_loaders(dump):
    kw = dict(batch_size=2, num_workers=2, seed=5, worker_type="process")
    a = port_loader.DataLoader(_pair(port_scannet, *dump), **kw)
    b = port_loader.DataLoader(_pair(port_scannet, *dump), **kw)
    try:
        first, second = list(a), list(a)
        assert not np.array_equal(first[0]["point_clouds"], second[0]["point_clouds"])
        assert_same_batches(list(b), first)
    finally:
        a.close()
        b.close()


def _ssl_loaders(module, data, split):
    labeled = module.ScannetSSLLabeledDataset(data, split, "labeled.txt", num_points=1024,
                                              use_height=True, augment=True)
    unlabeled = module.ScannetSSLUnlabeledDataset(data, split, "labeled.txt", num_points=1024,
                                                  use_height=True, augment=True,
                                                  load_labels=True)
    loader = jax_loader.DataLoader if module is jax_scannet else port_loader.DataLoader
    return (loader(labeled, 1, num_workers=2, seed=0, worker_type="process"),
            loader(unlabeled, 2, num_workers=2, seed=1, worker_type="process"))


def test_ssl_batcher_matches_jax_over_two_epochs(dump):
    ours, theirs = _ssl_loaders(port_scannet, *dump), _ssl_loaders(jax_scannet, *dump)
    try:
        ours_b, theirs_b = port_loader.SSLBatcher(*ours), jax_loader.SSLBatcher(*theirs)
        assert len(ours_b) == len(theirs_b) == 2
        for _ in range(2):
            got, want = list(ours_b), list(theirs_b)
            assert_same_batches(got, want)
        b = got[0]
        assert b["point_clouds"].shape == b["ema_point_clouds"].shape == (3, 1024, 4)
        assert b["center_label"].shape == (3, 64, 3)  # both sides hold it: view-stats labels
        assert b["vote_label"].shape == (1, 1024, 9)  # labeled only
        assert b["scale"].shape == (3, 1, 3) and b["rot_mat"].shape == (3, 3, 3)
        assert b["supervised_mask"].tolist() == [1, 0, 0]
    finally:
        for loader in ours + theirs:
            loader.close()


def test_ssl_batcher_refuses_an_unlabeled_loader_without_batches():
    labeled = port_loader.DataLoader(ExitsAt(n=2, bad=-1), 2, num_workers=0)
    unlabeled = port_loader.DataLoader(ExitsAt(n=2, bad=-1), 4, num_workers=0)
    with pytest.raises(RuntimeError, match="no batches"):
        next(iter(port_loader.SSLBatcher(labeled, unlabeled)))


def test_prefetch_forwards_the_producers_exception():
    def gen():
        yield 1
        raise ValueError("boom")

    it = port_loader.prefetch(gen())
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        next(it)


class Unpicklable:
    def __init__(self):
        self.lock = threading.Lock()

    def __len__(self):
        return 2

    def __getitem__(self, i):
        return {"x": np.full(3, i)}


def test_failed_process_workers_raise_and_never_turn_into_threads(monkeypatch):
    # forked workers inherit any dataset; spawned ones need it pickled
    get_context = port_loader.multiprocessing.get_context
    monkeypatch.setattr(port_loader.multiprocessing, "get_context", lambda _: get_context("spawn"))
    with pytest.raises(TypeError, match="pickle"):
        port_loader.DataLoader(Unpicklable(), 1, num_workers=2, worker_type="process")
    monkeypatch.setattr(jax_loader.multiprocessing, "get_context", lambda _: get_context("spawn"))
    theirs = jax_loader.DataLoader(Unpicklable(), 1, num_workers=2, worker_type="process")
    assert theirs.worker_type == "thread"  # the JAX loader's quiet switch
    theirs.close()
    monkeypatch.undo()
    # forked, the port's workers run the same dataset
    ours = port_loader.DataLoader(Unpicklable(), 1, shuffle=False, num_workers=2,
                                  worker_type="process")
    try:
        assert [b["x"].tolist() for b in ours] == [[[0, 0, 0]], [[1, 1, 1]]]
    finally:
        ours.close()
    dying = port_loader.DataLoader(ExitsAt(n=4, bad=1), 2, shuffle=False, num_workers=2,
                                   worker_type="process")
    try:
        with pytest.raises(BrokenProcessPool):
            list(dying)
        assert dying.worker_type == "process"
    finally:
        dying.close()
    with pytest.raises(ValueError, match="worker_type"):
        port_loader.DataLoader(ExitsAt(), 1, worker_type="fork")


def _host_batch(rng):
    return {"point_clouds": rng.randn(2, 50, 4).astype(np.float32),
            "vote_label_mask": rng.randint(0, 2, (2, 50)).astype(np.int64),
            "rot_mat": rng.randn(2, 3, 3).astype(np.float32),
            "scale": rng.rand(2, 1, 3).astype(np.float32),
            "flip_x_axis": np.array([0, 1], np.int64),
            "scan_idx": np.arange(2, dtype=np.int64),
            "rot_angle": np.zeros(2, np.float32)}


def test_stage_batch_on_the_cpu_is_a_copy_of_each_leaf():
    batch = _host_batch(np.random.RandomState(0))
    staged = stage_batch(batch, device="cpu")
    assert list(staged) == list(batch)
    for k, v in batch.items():
        assert staged[k].dtype == torch.from_numpy(v).dtype, k
        assert torch.equal(staged[k], torch.from_numpy(v)), k
        assert staged[k].data_ptr() != torch.from_numpy(v).data_ptr(), k


def test_stage_batch_needs_cuda_unless_a_device_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        stage_batch(_host_batch(np.random.RandomState(0)))


def test_layout_packs_every_leaf_aligned_in_key_order():
    batch = _host_batch(np.random.RandomState(1))
    batch["odd"] = np.zeros(7, np.uint8)  # leaves the next offset unaligned
    batch["empty"] = np.zeros((0, 3), np.float32)
    slots, total = layout(batch)
    assert [s[0] for s in slots] == sorted(batch)
    end = 0
    for key, dtype, shape, offset, nbytes in slots:
        assert offset % ALIGN == 0 and offset >= end, key
        assert (dtype, shape, nbytes) == (batch[key].dtype, batch[key].shape, batch[key].nbytes)
        assert offset - end < ALIGN
        end = offset + nbytes
    assert total == end


def _tiny_model():
    from iou3dmatch_tpu_torch.models.factory import build_votenet

    return build_votenet("scannet", tiny=True, device="cpu")


def test_the_steps_run_on_loader_batches(dump):
    from iou3dmatch_tpu_torch.train.state import create_train_state
    from iou3dmatch_tpu_torch.train.steps import make_pretrain_step, make_ssl_step

    model, cfg = _tiny_model()
    state = create_train_state(model)
    loader = port_loader.DataLoader(_pair(port_scannet, *dump), 2, num_workers=0)
    batch = stage_batch(next(iter(loader)), device="cpu")
    metrics = make_pretrain_step(cfg)(state, batch, 1e-3, 0.5)
    assert torch.isfinite(metrics["loss"])

    model, cfg = _tiny_model()
    state = create_train_state(model, with_ema=True)
    labeled, unlabeled = _ssl_loaders(port_scannet, *dump)
    try:
        batch = stage_batch(next(iter(port_loader.SSLBatcher(labeled, unlabeled))), device="cpu")
    finally:
        labeled.close()
        unlabeled.close()
    assert batch["flip_x_axis"].dtype == torch.int64 and batch["scale"].shape == (3, 1, 3)
    step = make_ssl_step(cfg, 1, reference_exact=True, view_stats=True)
    metrics = step(state, batch, 2e-3, 0.5)
    assert torch.isfinite(metrics["loss"]) and state.step == 1


def test_evaluate_over_the_port_loader_matches_jax(tmp_path):
    from iou3dmatch_tpu.cli import common as jax_common
    from iou3dmatch_tpu.data import get_config as jax_get_config
    from iou3dmatch_tpu.models.factory import build_votenet as build_jax
    from iou3dmatch_tpu.train.state import TrainState
    from iou3dmatch_tpu.train.steps import make_eval_forward as jax_eval_forward

    from iou3dmatch_tpu_torch.cli import common as port_common
    from iou3dmatch_tpu_torch.train.steps import make_eval_loss
    from iou3dmatch_tpu_torch.train.torch_import import state_dict_from_jax

    root = write_scannet_dump(tmp_path, seed=3, n_train=1, n_val=4)
    data, split = str(root / "scannet_train_detection_data"), str(root / "meta_data")
    jm, _ = build_jax("scannet", tiny=True)
    variables = jax.jit(lambda x: jm.init({"params": jax.random.PRNGKey(7)}, x, train=False))(
        jnp.zeros((2, 2048, 4), jnp.float32))
    variables = jax.tree.map(np.asarray, variables)
    pm, pcfg = _tiny_model()
    pm.load_state_dict(state_dict_from_jax(variables), strict=True)

    def val(module):
        return module.ScannetDetectionDataset(data, split, "val", num_points=2048,
                                              use_height=True, augment=False)

    # GT on the model's own proposals: each val scene as the process loader
    # will draw it, the port's forward, and six of its boxes written back as
    # the scene's boxes (the cloud and its draws do not read them)
    ds = val(port_scannet)
    for i, name in enumerate(ds.scan_names):
        np.random.seed(port_loader.sample_seed(0, 0, i))
        pc = torch.from_numpy(ds[i]["point_clouds"][None])
        with torch.no_grad():
            ep = {k: v[0].numpy() for k, v in pm(pc).items()}
        cls = ep["sem_cls_scores"][:6].argmax(-1)
        size_cls = ep["size_scores"][:6].argmax(-1)
        size = pcfg.mean_size_arr[size_cls] + ep["size_residuals"][np.arange(6), size_cls]
        boxes = np.c_[ep["center"][:6], size, pcfg.nyu40ids[cls]]
        np.save(f"{data}/{name}_bbox.npy", boxes)

    args = types.SimpleNamespace(use_iou_for_nms=True, conf_thresh=0.05)
    kw = dict(batch_size=2, shuffle=False, drop_last=False, num_workers=2, seed=0,
              worker_type="process")
    ours, theirs = port_loader.DataLoader(val(port_scannet), **kw), \
        jax_loader.DataLoader(val(jax_scannet), **kw)
    try:
        assert theirs.worker_type == "process"
        jcfg = jax_get_config("scannet")
        state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                           opt_state=None, step=jnp.asarray(0))
        want = jax_common.evaluate(jm, jcfg, state, theirs, jax_common.make_config_dict(jcfg, args),
                                   lambda _: None, jax_eval_forward(jm, jcfg))
        got = port_common.evaluate(pm, pcfg, (stage_batch(b, device="cpu") for b in ours),
                                   port_common.make_config_dict(pcfg, args), lambda _: None,
                                   make_eval_loss(pm, pcfg))
    finally:
        ours.close()
        theirs.close()
    for t in (0.25, 0.5):
        for key in ("mAP", "AR"):
            assert got[1][t][key] == want[1][t][key], (t, key, got[1][t][key], want[1][t][key])
    assert got[1][0.25]["mAP"] > 0
