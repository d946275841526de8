"""The port's ``three_interpolate``, forward and backward, against the JAX
package's, on the CPU.

- The forward, which the wrapper runs on CPU tensors as
  ``three_interpolate_plain``, against JAX's ``three_interpolate`` at
  FP1- and FP2-like small shapes and on edge cases: indices repeated
  within a query and shared across queries, indices out of range that the
  clamp catches, zero weights, one known row (m = 1), a channel count that
  is not a multiple of 4. Tolerance rtol 1e-6 (both sum three f32
  products).
- The gradient of the features, through the port's autograd Function (its
  plain backward, an ``index_add_`` of g w), against ``jax.vjp`` through
  JAX's custom VJP (``_interp_bwd``, a one-hot segment sum): each of the
  two within rtol 1e-5 of a float64 sum, relative to the sum of the
  magnitudes added into the element (the gate the gather's backward is
  held to on the card). ``idx`` and ``weight`` get no gradient.
- ``kernel_model``, a NumPy model of ``csrc/three_interpolate.cu``'s
  rounding (each product f w rounded to f32, then ((0 + p0) + p1) + p2 in
  f32: the sum starts from its identity, so a sum of -0 products is +0, as
  PyTorch's), equals the plain forward bit for bit, the sign of zeros
  included (the zero-weight case has queries whose every product is -0);
  so the kernel, which the card holds to the plain version, rounds as this
  model does.
- ``PointnetFPModule`` in train mode against the flax module: the output
  within atol 1e-4 (``tests/test_torch_models.py``'s) and the gradients
  of every parameter and of the known features within 1e-4 of the largest
  entry (``tests/test_torch_model_parts.py``'s).
- On CPU tensors the wrappers count no launch.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from iou3dmatch_tpu_torch.models import pointnet2 as pp  # noqa: E402
from iou3dmatch_tpu_torch.models.mlp import set_bn_momentum  # noqa: E402
from iou3dmatch_tpu_torch.ops.interpolate import (  # noqa: E402
    three_interpolate, three_interpolate_backward, three_interpolate_backward_plain,
    three_interpolate_plain)
from iou3dmatch_tpu_torch.train.torch_import import state_dict_from_jax  # noqa: E402

jp = pytest.importorskip("iou3dmatch_tpu.models.pointnet2")
torch.set_num_threads(1)
FWD_RTOL = 1e-6
BWD_RTOL = 1e-5
MODULE_ATOL = 1e-4
GRAD_RTOL = 1e-4
MOMENTUM = 0.1


def _weights(rng, b, n):
    """Inverse-distance weights as FP makes them: 1 / (d + 1e-8), normalised."""
    recip = 1.0 / (rng.uniform(0.01, 2.0, (b, n, 3)) + 1e-8)
    return (recip / recip.sum(-1, keepdims=True)).astype(np.float32)


def _case(name):
    """(features (B, m, C), idx (B, n, 3) int32, weight (B, n, 3)) from a
    NumPy seed."""
    rng = np.random.RandomState(sorted(CASES).index(name))
    b, m, n, c = CASES[name]
    feats = rng.randn(b, m, c).astype(np.float32)
    idx = rng.randint(0, m, (b, n, 3)).astype(np.int32)
    w = _weights(rng, b, n)
    if name == "repeats":
        idx[:, ::3, 1] = idx[:, ::3, 0]  # a row twice in one query
        idx[:, ::5] = idx[:, :1]  # one triple shared by many queries
        idx[:, 1::7, :] = 2  # the same row three times
    elif name == "out_of_range":
        idx[:, ::2, 0] = -rng.randint(1, 5, idx[:, ::2, 0].shape)
        idx[:, 1::3, 2] = m + rng.randint(0, 5, idx[:, 1::3, 2].shape)
        idx[:, 5, :] = [-1, m, 1 << 30]
    elif name == "zero_weights":
        w[:, ::2, 1] = 0.0
        w[:, 1::4, :] = 0.0
        w[:, 3::4, 0] = 1.0
    return feats, idx, w


CASES = {  # (B, m, n, C)
    "fp1": (2, 32, 64, 24),  # FP1's ratio: n = 2m
    "fp2": (2, 64, 128, 24),
    "repeats": (2, 16, 60, 8),
    "out_of_range": (3, 20, 40, 12),
    "zero_weights": (2, 24, 48, 8),
    "one_row": (2, 1, 30, 16),
    "ragged_channels": (3, 17, 37, 5),
}


def _jax_forward(feats, idx, w):
    from iou3dmatch_tpu.ops.interpolate import three_interpolate as jax_interp

    return np.asarray(jax_interp(jnp.asarray(feats), jnp.asarray(idx), jnp.asarray(w)))


def _f64_backward(g, idx, w, m):
    """The features' gradient summed in float64, and the sum of the
    magnitudes added into each element."""
    g, w = torch.from_numpy(g).double(), torch.from_numpy(w).double()
    idx = torch.from_numpy(idx)
    return (three_interpolate_backward_plain(g, idx, w, m).numpy(),
            three_interpolate_backward_plain(g.abs(), idx, w.abs(), m).numpy())


def kernel_model(feats, idx, w):
    """csrc/three_interpolate.cu's arithmetic in NumPy float32: each index
    clamped to [0, m - 1], each product f w rounded to f32, then
    ((0 + p0) + p1) + p2, each sum rounded to f32."""
    b, m, _ = feats.shape
    i = np.clip(idx.astype(np.int64), 0, m - 1)
    rows = feats[np.arange(b)[:, None, None], i]  # (B, n, 3, C)
    p = rows * w[..., None]
    return ((np.float32(0) + p[:, :, 0]) + p[:, :, 1]) + p[:, :, 2]


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax(name):
    feats, idx, w = _case(name)
    got = three_interpolate(torch.from_numpy(feats), torch.from_numpy(idx), torch.from_numpy(w))
    assert got.dtype == torch.float32 and tuple(got.shape) == (idx.shape[0], idx.shape[1],
                                                               feats.shape[2])
    np.testing.assert_allclose(got.numpy(), _jax_forward(feats, idx, w), rtol=FWD_RTOL, atol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_model_is_the_plain_forward_bit_for_bit(name):
    feats, idx, w = _case(name)
    want = three_interpolate_plain(torch.from_numpy(feats), torch.from_numpy(idx),
                                   torch.from_numpy(w)).numpy()
    got = kernel_model(feats, idx, w)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradient_matches_jax_vjp(name):
    from iou3dmatch_tpu.ops.interpolate import three_interpolate as jax_interp

    feats, idx, w = _case(name)
    m = feats.shape[1]
    g = np.random.RandomState(40).randn(idx.shape[0], idx.shape[1], feats.shape[2]).astype(
        np.float32)
    f = torch.from_numpy(feats).requires_grad_()
    weight = torch.from_numpy(w).requires_grad_()
    out = three_interpolate(f, torch.from_numpy(idx), weight)
    got_f, got_w = torch.autograd.grad(out, (f, weight), torch.from_numpy(g), allow_unused=True)
    assert got_w is None  # the weights get no gradient, as in JAX's VJP
    _, vjp = jax.vjp(lambda x: jax_interp(x, jnp.asarray(idx), jnp.asarray(w)),
                     jnp.asarray(feats))
    want, = vjp(jnp.asarray(g))
    ref, mag = _f64_backward(g, idx, w, m)
    for what, grad in (("port", got_f.numpy()), ("jax", np.asarray(want))):
        assert grad.dtype == np.float32
        bad = np.abs(grad.astype(np.float64) - ref) > BWD_RTOL * mag
        assert not bad.any(), (what, np.abs(grad - ref).max())
    # rows no slot names get exact zeros on both sides
    named = np.zeros((idx.shape[0], m), bool)
    np.put_along_axis(named, np.clip(idx, 0, m - 1).reshape(idx.shape[0], -1), True, axis=1)
    assert (got_f.numpy()[~named] == 0).all() and (np.asarray(want)[~named] == 0).all()


def test_jax_backward_is_the_plain_backward():
    """JAX's ``_interp_bwd`` (the one-hot segment sum) against the port's
    ``three_interpolate_backward_plain`` called directly, and the backward
    wrapper on CPU tensors returning the plain one's result."""
    from iou3dmatch_tpu.ops.interpolate import _interp_bwd

    feats, idx, w = _case("out_of_range")
    m = feats.shape[1]
    g = np.random.RandomState(41).randn(idx.shape[0], idx.shape[1], feats.shape[2]).astype(
        np.float32)
    want, none_i, none_w = _interp_bwd((jnp.asarray(idx), jnp.asarray(w), m), jnp.asarray(g))
    assert none_i is None and none_w is None
    args = (torch.from_numpy(g), torch.from_numpy(idx), torch.from_numpy(w), m)
    got = three_interpolate_backward_plain(*args)
    assert torch.equal(three_interpolate_backward(*args), got)
    ref, mag = _f64_backward(g, idx, w, m)
    for grad in (got.numpy(), np.asarray(want)):
        assert not (np.abs(grad.astype(np.float64) - ref) > BWD_RTOL * mag).any()


def test_no_gradient_for_indices_or_weights():
    feats, idx, w = _case("fp1")
    weight = torch.from_numpy(w).requires_grad_()
    for f in (torch.from_numpy(feats), torch.from_numpy(feats).requires_grad_()):
        out = three_interpolate(f, torch.from_numpy(idx), weight)
        grad, = torch.autograd.grad(out.sum(), weight, allow_unused=True)
        assert grad is None


def test_cpu_wrappers_count_no_launch_and_refuse_bad_shapes():
    feats, idx, w = _case("fp2")
    before = (three_interpolate.launches, three_interpolate_backward.launches)
    f = torch.from_numpy(feats).requires_grad_()
    three_interpolate(f, torch.from_numpy(idx), torch.from_numpy(w)).sum().backward()
    assert (three_interpolate.launches, three_interpolate_backward.launches) == before
    # float64 on the CPU (the port's float64 steps): the plain version in float64
    got = three_interpolate(torch.from_numpy(feats).double(), torch.from_numpy(idx),
                            torch.from_numpy(w).double())
    assert got.dtype == torch.float64
    with pytest.raises(ValueError, match="idx and weight"):
        three_interpolate(torch.from_numpy(feats), torch.from_numpy(idx[..., :2]),
                          torch.from_numpy(w[..., :2]))
    with pytest.raises(ValueError, match="known row"):
        three_interpolate(torch.zeros((2, 0, 4)), torch.from_numpy(idx[:2]),
                          torch.from_numpy(w[:2]))


FP_MLP = (24 + 8, 32, 16)  # [interpolated | skip] channels, then two layers


@pytest.mark.parametrize("skip", [True, False])
def test_fp_module_forward_and_gradients_match_flax(skip):
    """Train mode: the output, the BN-normalised step's gradient of a random
    projection of the output with respect to every parameter and to the
    known features (the interpolated table), against the flax module."""
    rng = np.random.RandomState(42)
    b, n, m = 2, 64, 32
    unknown = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    known = rng.uniform(-1, 1, (b, m, 3)).astype(np.float32)
    kf = rng.randn(b, m, 24).astype(np.float32)
    uf = rng.randn(b, n, 8).astype(np.float32) if skip else None
    mlp = FP_MLP if skip else (24,) + FP_MLP[1:]
    jm = jp.PointnetFPModule(mlp=mlp)
    jargs = (jnp.asarray(unknown), jnp.asarray(known), None if uf is None else jnp.asarray(uf))
    variables = jax.tree.map(np.asarray, dict(jm.init(jax.random.PRNGKey(3), *jargs,
                                                       jnp.asarray(kf), train=False)))
    out_shape = (b, n, mlp[-1])
    proj = rng.randn(*out_shape).astype(np.float32)

    def loss(params, known_feats):
        out, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, *jargs,
                          known_feats, train=True, momentum=MOMENTUM, mutable=["batch_stats"])
        return jnp.sum(out * proj), out

    (_, want_out), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(kf))
    pm = pp.PointnetFPModule(mlp, torch.Generator().manual_seed(0))
    # the key rule names a lone module's shared MLP as an SA module's
    pm.load_state_dict({k.replace("mlp_module.", "mlp.", 1): v
                        for k, v in state_dict_from_jax(variables).items()}, strict=True)
    pm.train()
    set_bn_momentum(pm, MOMENTUM)
    tk = torch.from_numpy(kf).requires_grad_()
    out = pm(torch.from_numpy(unknown), torch.from_numpy(known),
             None if uf is None else torch.from_numpy(uf), tk)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=0,
                               atol=MODULE_ATOL)
    (out * torch.from_numpy(proj)).sum().backward()
    want = {k.replace("mlp_module.", "mlp.", 1): v for k, v in
            state_dict_from_jax({"params": jax.tree.map(np.asarray, grads[0])}).items()}
    got = {k: p.grad for k, p in pm.named_parameters()}
    assert set(got) == set(want)
    for k, v in list(want.items()) + [("known features", torch.from_numpy(np.asarray(grads[1])))]:
        g = tk.grad if k == "known features" else got[k]
        scale = float(np.abs(v.numpy()).max())
        assert scale > 0, k
        np.testing.assert_allclose(g.numpy(), v.numpy(), rtol=0, atol=GRAD_RTOL * scale,
                                   err_msg=k)
