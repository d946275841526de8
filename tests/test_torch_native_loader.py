"""The port's native loader kernels against the JAX package's, on the CPU.

``compute_votes_native`` and ``percentile_native`` of
``iou3dmatch_tpu_torch/native/loader.py`` on the inputs of
``tests/test_native.py:64-148``: the votes bit for bit equal to the JAX
kernel's, to the port's NumPy form ``compute_votes_plain`` and to the
reference's per-instance loop; the 0.99 percentile bit for bit equal to the
JAX kernel's and to ``np.percentile``, returning None in exactly the cases
the JAX kernel does (an exact zero at the percentile). A source that does not
compile raises with g++'s output, and a percentile that disagrees with NumPy
fails the library's self-check, where the JAX package falls back to NumPy.
"""
import numpy as np
import pytest

from iou3dmatch_tpu.data import scannet as jax_scannet
from iou3dmatch_tpu.native import loader as jax_native

from iou3dmatch_tpu_torch import native
from iou3dmatch_tpu_torch.data import scannet as port_scannet
from iou3dmatch_tpu_torch.native import loader as port_native


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_percentile_matches_jax_and_numpy_bit_for_bit(dtype):
    rng = np.random.RandomState(0)
    deferred = 0
    for trial in range(300):
        n = rng.randint(1, 60000)
        z = ((rng.rand(n) - 0.3) * float(rng.choice([0.01, 1, 1000]))).astype(dtype)
        if trial % 7 == 0:
            z = np.round(z, 1).astype(dtype)  # heavy ties
        if trial % 11 == 0:
            z[:] = z[0]  # constant
        if trial % 13 == 0:
            z[rng.randint(n)] = 0  # an exact zero, at the percentile where n is small
        got = port_native.percentile_native(z, 0.99)
        want = jax_native.percentile_native(z, 0.99)
        if want is None:
            assert got is None and (z == 0).any()
            deferred += 1
            continue
        ref = np.percentile(z, 0.99)
        for other in (want, ref):
            assert np.asarray(got).dtype == np.asarray(other).dtype
            assert np.asarray(got).tobytes() == np.asarray(other).tobytes(), (n, got, other)
    assert deferred > 0


def test_percentile_defers_nan_and_rejects_other_input():
    z = np.array([1.0, np.nan, 2.0], np.float32)
    assert port_native.percentile_native(z, 0.99) is None
    assert jax_native.percentile_native(z, 0.99) is None
    with pytest.raises(TypeError, match="float32 or float64"):
        port_native.percentile_native(np.arange(5), 0.99)
    with pytest.raises(ValueError, match="1-D"):
        port_native.percentile_native(np.zeros((2, 2), np.float32), 0.99)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_votes_match_jax_the_plain_form_and_the_reference_loop(dtype):
    rng = np.random.RandomState(2)
    ids = port_scannet.DC.nyu40ids
    assert np.array_equal(ids, jax_scannet.DC.nyu40ids)
    for _ in range(15):
        n = int(rng.randint(1, 3000))
        pc = (rng.randn(n, 4) * 3).astype(dtype)
        ins = rng.randint(0, 30, n).astype(np.int64)
        sem = rng.randint(0, 41, n).astype(np.int64)
        votes, mask = port_native.compute_votes_native(pc, ins, sem, ids)
        jax_votes, jax_mask = jax_native.compute_votes_native(pc, ins, sem, ids)
        plain_votes, plain_mask = port_native.compute_votes_plain(pc, ins, sem, ids)
        loop_votes, loop_mask = np.zeros((n, 3)), np.zeros(n)
        for i_instance in np.unique(ins):
            ind = np.where(ins == i_instance)[0]
            if sem[ind[0]] in ids:
                x = pc[ind, :3]
                loop_votes[ind, :] = 0.5 * (x.min(0) + x.max(0)) - x
                loop_mask[ind] = 1.0
        for other_votes, other_mask in ((jax_votes, jax_mask), (plain_votes, plain_mask),
                                        (loop_votes, loop_mask)):
            assert votes.dtype == other_votes.dtype and mask.dtype == other_mask.dtype
            assert votes.tobytes() == other_votes.tobytes()
            assert mask.tobytes() == other_mask.tobytes()
        tiled, tiled_mask = port_scannet._compute_votes(pc, ins, sem)
        assert tiled.tobytes() == np.tile(votes, (1, 3)).tobytes()
        assert tiled_mask.tobytes() == mask.tobytes()


def test_votes_refuse_other_clouds():
    with pytest.raises(TypeError, match="float32 or float64"):
        port_native.compute_votes_native(np.zeros((4, 3), np.int32), np.zeros(4, np.int64),
                                         np.zeros(4, np.int64), [3])
    with pytest.raises(ValueError, match="labels"):
        port_native.compute_votes_native(np.zeros((4, 3), np.float32), np.zeros(3, np.int64),
                                         np.zeros(4, np.int64), [3])


@pytest.mark.parametrize("use_color", [False, True])
def test_prep_cloud_height_matches_jax(use_color):
    rng = np.random.RandomState(3)
    verts = (rng.rand(5000, 6) * np.array([8, 8, 3, 255, 255, 255])).astype(np.float32)
    got = port_scannet._prep_cloud(verts.copy(), use_color, True)
    want = jax_scannet._prep_cloud(verts.copy(), use_color, True)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    floor = np.percentile(verts[:, 2], 0.99)
    assert got[:, -1].tobytes() == (verts[:, 2] - floor).tobytes()


def test_a_source_that_does_not_compile_raises_with_gpp_output(tmp_path):
    broken = tmp_path / "broken_loader_host.cc"
    broken.write_text(port_native.SRC.read_text() + "\nthis is not C++;\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for broken_loader_host.cc") as err:
        native.build_library(broken, port_native.FLAGS)
    assert "error" in str(err.value)
    assert not native.library_path(broken, port_native.FLAGS).exists()


def test_a_percentile_that_disagrees_with_numpy_fails_the_self_check(monkeypatch):
    lib = port_native.load()
    monkeypatch.setattr(port_native.np, "percentile", lambda z, q: z.min())
    with pytest.raises(RuntimeError, match="NumPy's quantile rule changed"):
        port_native._percentile_self_check(lib)
