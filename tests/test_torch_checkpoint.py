"""The port's checkpoints against the JAX package's, on the CPU.

- ``save`` then ``load`` into a fresh state gives equal tensors: the model,
  the teacher, every tensor of Adam's state, the step count and the jitter
  generator, for a pretrain and an SSL state; the write goes through a
  ``.tmp`` file, so a failed write leaves the last file whole.
- Resume: 2 steps, save, load into a fresh state, 1 step equals 3 steps
  bit for bit (weights, BN statistics, Adam's state, the teacher, the
  step's metrics) on a tiny model, pretrain and SSL.
- The JAX package's ``checkpoint.load`` reads the port's file through its
  torch route (``_load_torch``): its weights, brought back by
  ``state_dict_from_jax``, equal the port's bit for bit, and its forward
  agrees with the port's within 1e-4 (``tests/test_torch_models.py``'s
  tolerance).
- The port loads what the JAX package's ``cli/export_torch.py`` writes: the
  weights and the teacher bit for bit, Adam left fresh.
- ``load_pretrain_into_ssl`` on both packages agrees: the student and the
  teacher equal the saved model, in tensors of their own, with a fresh
  Adam.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from iou3dmatch_tpu.models.factory import build_votenet as build_jax  # noqa: E402
from iou3dmatch_tpu.train import checkpoint as jax_checkpoint  # noqa: E402
from iou3dmatch_tpu.train.state import create_train_state as jax_train_state  # noqa: E402

from iou3dmatch_tpu_torch.data.loader import DataLoader, SSLBatcher  # noqa: E402
from iou3dmatch_tpu_torch.data.staging import stage_batch  # noqa: E402
from iou3dmatch_tpu_torch.data.synthetic import SyntheticDataset  # noqa: E402
from iou3dmatch_tpu_torch.models.factory import build_votenet  # noqa: E402
from iou3dmatch_tpu_torch.train import checkpoint  # noqa: E402
from iou3dmatch_tpu_torch.train.state import create_train_state  # noqa: E402
from iou3dmatch_tpu_torch.train.steps import KEEP, make_pretrain_step, make_ssl_step  # noqa: E402
from iou3dmatch_tpu_torch.train.torch_import import state_dict_from_jax  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-4
POINTS = 1024


def _batch(ssl: bool) -> dict:
    """A loader batch of synthetic scenes: 2 scenes, or 1 labeled + 1
    unlabeled with view-stats labels."""
    if not ssl:
        loader = DataLoader(SyntheticDataset(num_scenes=2, num_points=POINTS), 2, num_workers=0)
        return stage_batch(next(iter(loader)), device="cpu")
    labeled = DataLoader(SyntheticDataset(num_scenes=1, num_points=POINTS, ssl=True), 1,
                         num_workers=0)
    unlabeled = DataLoader(SyntheticDataset(num_scenes=1, num_points=POINTS, ssl=True,
                                            labeled=False, load_labels=True, seed=3), 1,
                           num_workers=0)
    return stage_batch(next(iter(SSLBatcher(labeled, unlabeled))), device="cpu")


def _state(ssl: bool, seed: int = 0):
    model, cfg = build_votenet("scannet", tiny=True, device="cpu",
                               generator=torch.Generator().manual_seed(seed))
    return create_train_state(model, seed=seed, with_ema=ssl), cfg


def _step(cfg, ssl: bool):
    if ssl:
        return make_ssl_step(cfg, 1, reference_exact=True, view_stats=True)
    return make_pretrain_step(cfg)


def _tensors(state) -> dict:
    """Every tensor a resumed run depends on, by name."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    if state.ema_model is not None:
        out.update({f"ema.{k}": v for k, v in state.ema_model.state_dict().items()})
    for i, s in state.optimizer.state_dict()["state"].items():
        out.update({f"adam.{i}.{k}": torch.as_tensor(v) for k, v in s.items()})
    out["generator"] = state.generator.get_state()
    return out


def assert_same_state(got, want):
    a, b = _tensors(got), _tensors(want)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    assert got.step == want.step


@pytest.mark.parametrize("ssl", [False, True], ids=["pretrain", "ssl"])
def test_save_then_load_gives_equal_tensors(tmp_path, ssl):
    state, cfg = _state(ssl)
    _step(cfg, ssl)(state, _batch(ssl), 1e-3, 0.5)
    path = str(tmp_path / "checkpoint.tar")
    checkpoint.save(path, state, epoch=7, loss=1.25)
    assert not (tmp_path / "checkpoint.tar.tmp").exists()
    fresh, _ = _state(ssl, seed=1)
    assert checkpoint.load(path, fresh) == (7, 1.25)
    assert len(state.optimizer.state) > 0
    assert_same_state(fresh, state)
    payload = torch.load(path, weights_only=True)
    want = {"epoch", "loss", "model_state_dict", "optimizer_state_dict", "step",
            "generator_state"} | ({"ema_model_state_dict"} if ssl else set())
    assert set(payload) == want


def test_a_failed_write_leaves_the_last_checkpoint(tmp_path, monkeypatch):
    state, _ = _state(False)
    path = str(tmp_path / "checkpoint.tar")
    checkpoint.save(path, state, epoch=1)
    before = (tmp_path / "checkpoint.tar").read_bytes()

    def broken_save(obj, f):
        with open(f, "wb") as out:
            out.write(b"half a file")
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint.torch, "save", broken_save)
    with pytest.raises(OSError, match="disk full"):
        checkpoint.save(path, state, epoch=2)
    assert (tmp_path / "checkpoint.tar").read_bytes() == before


@pytest.mark.parametrize("ssl", [False, True], ids=["pretrain", "ssl"])
def test_resume_is_the_uninterrupted_run_bit_for_bit(tmp_path, ssl):
    batch = _batch(ssl)
    straight, cfg = _state(ssl)
    step = _step(cfg, ssl)
    for _ in range(3):
        want = step(straight, batch, 1e-3, 0.5)

    resumed, _ = _state(ssl)
    for _ in range(2):
        step(resumed, batch, 1e-3, 0.5)
    path = str(tmp_path / "checkpoint.tar")
    checkpoint.save(path, resumed, epoch=2)
    resumed, _ = _state(ssl, seed=1)
    checkpoint.load(path, resumed)
    got = step(resumed, batch, 1e-3, 0.5)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert_same_state(resumed, straight)


def _jax_pair(ssl: bool):
    jm, _ = build_jax("scannet", tiny=True)
    example = {"point_clouds": jnp.zeros((1, POINTS, 4), jnp.float32)}
    return jm, jax_train_state(jm, jax.random.PRNGKey(3), example, with_ema=ssl)


def _sd(params, batch_stats) -> dict:
    return state_dict_from_jax({"params": jax.tree.map(np.asarray, params),
                                "batch_stats": jax.tree.map(np.asarray, batch_stats)})


def assert_same_weights(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _scenes(seed):
    rng = np.random.RandomState(seed)
    pc = np.zeros((2, POINTS, 4), np.float32)
    pc[..., 0:3] = rng.uniform(-3.0, 3.0, (2, POINTS, 3))
    pc[..., 3] = pc[..., 2] - pc[..., 2].min(axis=1, keepdims=True)
    return pc


@pytest.mark.parametrize("ssl", [False, True], ids=["pretrain", "ssl"])
def test_jax_reads_the_port_file_and_its_forward_agrees(tmp_path, ssl):
    state, cfg = _state(ssl)
    _step(cfg, ssl)(state, _batch(ssl), 1e-3, 0.5)
    path = str(tmp_path / "checkpoint.tar")
    checkpoint.save(path, state, epoch=4, loss=0.5)
    jm, template = _jax_pair(ssl)
    loaded, epoch, loss = jax_checkpoint.load(path, template)
    assert (epoch, loss) == (4, 0.5)
    assert_same_weights(_sd(loaded.params, loaded.batch_stats), state.model.state_dict())
    if ssl:
        assert_same_weights(_sd(loaded.ema_params, loaded.ema_batch_stats),
                            state.ema_model.state_dict())
    pc = _scenes(9)
    want = jm.apply({"params": loaded.params, "batch_stats": loaded.batch_stats},
                    jnp.asarray(pc), train=False)
    state.model.eval()
    with torch.no_grad():
        got = state.model(torch.from_numpy(pc))
    for k in KEEP:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=ATOL,
                                   err_msg=k)


def test_the_port_loads_the_jax_export(tmp_path):
    from iou3dmatch_tpu.cli.export_torch import main as export_torch

    _, jax_state = _jax_pair(True)
    src, out = str(tmp_path / "ckpt.msgpack"), str(tmp_path / "checkpoint.tar")
    jax_checkpoint.save(src, jax_state, epoch=3, loss=0.75)
    export_torch([src, out, "--tiny", "--num_target", "16"])
    state, _ = _state(True, seed=1)
    assert checkpoint.load(out, state) == (3, 0.75)
    assert_same_weights(state.model.state_dict(),
                        _sd(jax_state.params, jax_state.batch_stats))
    assert_same_weights(state.ema_model.state_dict(),
                        _sd(jax_state.ema_params, jax_state.ema_batch_stats))
    assert len(state.optimizer.state) == 0 and state.step == 0


def test_load_pretrain_into_ssl_agrees_with_jax(tmp_path):
    pretrain, cfg = _state(False)
    _step(cfg, False)(pretrain, _batch(False), 1e-3, 0.5)
    path = str(tmp_path / "pretrain.tar")
    checkpoint.save(path, pretrain, epoch=5)

    ssl, _ = _state(True, seed=1)
    _step(cfg, True)(ssl, _batch(True), 1e-3, 0.5)  # a used state: Adam and the step restart
    checkpoint.load_pretrain_into_ssl(path, ssl)
    want = pretrain.model.state_dict()
    for model in (ssl.model, ssl.ema_model):
        assert_same_weights(model.state_dict(), want)
    student, teacher = ssl.model.state_dict(), ssl.ema_model.state_dict()
    assert all(student[k].data_ptr() != teacher[k].data_ptr() for k in student)
    assert len(ssl.optimizer.state) == 0 and ssl.step == 0

    _, template = _jax_pair(True)
    loaded = jax_checkpoint.load_pretrain_into_ssl(path, template)
    assert_same_weights(_sd(loaded.params, loaded.batch_stats), student)
    assert_same_weights(_sd(loaded.ema_params, loaded.ema_batch_stats), teacher)

    with pytest.raises(ValueError, match="teacher"):
        checkpoint.load_pretrain_into_ssl(path, _state(False)[0])
