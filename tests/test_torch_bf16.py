"""The port's bf16 mixed precision against the JAX package's, module by
module, on the CPU.

JAX's ``compute_dtype="bfloat16"``: SharedMLP casts its input and Dense
weights to bf16 (f32 accumulation, bf16 out), BatchNorm normalises in f32
and returns bf16, the SharedMLP output is f32; SA3 and SA4 gather the
bitcast-packed bf16 table; GridConv interpolates in bf16. Each JAX module
is initialised (SA modules with ``exact_ball_query=True``), its BN running
statistics perturbed away from (0, 1), and its weights carried into the
port by ``state_dict_from_jax``; both take the same seeded NumPy inputs.

Tolerances (``tests/torch_bf16_cases.py::check_bf16``), and why: a bf16
output rounds an f32 value that the packages compute in another order (a
bf16 ``Dense`` alone differs from ``F.linear`` on ~8e-5 of the elements),
so it may land one bf16 ulp away, and a flip in one layer moves the next
layer's inputs. In eval mode at most 1e-3 of a SharedMLP's outputs are
more than one ulp apart; in train mode 1e-2, since the packages' batch
statistics (JAX one pass, the port two) differ in their last f32 bits and
move the rounding of more elements. Every element stays within one ulp of
the tensor's largest magnitude. BN running statistics: rtol 1e-5 and atol
1e-5 after one bf16 layer (the statistics of the same bf16 products), 2e-3
after a layer whose inputs differ by the flips above. Indices: equal.
"""
import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.tree_util as jtu  # noqa: E402
import torch  # noqa: E402

from iou3dmatch_tpu_torch.data.config import get_config  # noqa: E402
from iou3dmatch_tpu_torch.models import grid_conv as pgrid  # noqa: E402
from iou3dmatch_tpu_torch.models import pointnet2 as pp  # noqa: E402
from iou3dmatch_tpu_torch.models.factory import build_votenet  # noqa: E402
from iou3dmatch_tpu_torch.models.mlp import BatchNorm, SharedMLP, set_bn_momentum  # noqa: E402
from iou3dmatch_tpu_torch.ops import three_nn  # noqa: E402
from iou3dmatch_tpu_torch.train.torch_import import state_dict_from_jax  # noqa: E402
from torch_bf16_cases import bf16_ulps, check_bf16, cosine  # noqa: E402

pbq = importlib.import_module("iou3dmatch_tpu_torch.ops.ball_query")
jmlp = pytest.importorskip("iou3dmatch_tpu.models.mlp")
jp = pytest.importorskip("iou3dmatch_tpu.models.pointnet2")
jgrid = pytest.importorskip("iou3dmatch_tpu.models.grid_conv")
torch.set_num_threads(1)
BF16 = torch.bfloat16
MOMENTUM = 0.1
EVAL_SHARE, TRAIN_SHARE = 1e-3, 1e-2
# bf16 products summed in f32: the gradients of the two packages round
# their bf16 cotangents apart, as the outputs above
GRAD_COSINE = 0.999


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def perturb_batch_stats(variables, seed=5):
    rng = np.random.RandomState(seed)

    def perturb(path, x):
        names = [p.key for p in path]
        if names[0] != "batch_stats":
            return x
        if names[-1] == "mean":
            return (rng.randn(*x.shape) * 0.05).astype(x.dtype)
        return (1.0 + rng.uniform(-0.2, 0.2, x.shape)).astype(x.dtype)

    return jtu.tree_map_with_path(perturb, variables)


def init_jax(module, *args, seed=0, **kw):
    variables = module.init({"params": jax.random.PRNGKey(seed)}, *args, **kw)
    return perturb_batch_stats(_np(dict(variables)))


def jax_apply(module, variables, *args, train, **kw):
    """(outputs, batch stats after the call or None)."""
    if train:
        out, mut = module.apply(variables, *args, train=True, momentum=MOMENTUM,
                                mutable=["batch_stats"], **kw)
        return out, mut["batch_stats"]
    return module.apply(variables, *args, train=False, **kw), None


def port_apply(pm, *args, train, **kw):
    pm.train(train)
    set_bn_momentum(pm, MOMENTUM)
    with torch.no_grad():
        return pm(*args, **kw)


def check_stats(got: dict, want: dict, rtol=1e-5, atol=1e-5, first_rtol=None):
    """The port's running statistics against JAX's (a state dict) after a
    train-mode call; ``first_rtol`` for the first layer's, taken on the
    same bf16 products."""
    assert want
    for k, v in want.items():
        tol = first_rtol if first_rtol is not None and ".layer0." in k else rtol
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=tol, atol=atol, err_msg=k)


def jax_stats(stats) -> dict:
    return state_dict_from_jax({"batch_stats": _np(stats)})


def wrapped(variables, name="mlp"):
    """A bare SharedMLP's variables placed under ``name``, so that
    ``state_dict_from_jax`` gives the SharedMLP keys under ``mlp_module.``."""
    return {k: {name: variables[k]} for k in ("params", "batch_stats")}


def strip(sd: dict, prefix: str = "mlp_module.") -> dict:
    return {k[len(prefix):]: v for k, v in sd.items()}


def mlp_input(seed, shape=(2, 64, 16, 35)):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) * 2.0 + 0.5).astype(np.float32)


# ------------------------------------------------------------ SharedMLP / BN


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_shared_mlp_bf16_matches_flax(train):
    x = mlp_input(0)
    jm = jmlp.SharedMLP((64, 64, 128), dtype=jnp.bfloat16)
    variables = init_jax(jm, jnp.asarray(x), train=False)
    want, stats = jax_apply(jm, variables, jnp.asarray(x), train=train)
    assert want.dtype == jnp.float32
    pm = SharedMLP([35, 64, 64, 128], torch.Generator().manual_seed(0), dtype=BF16)
    pm.load_state_dict(strip(state_dict_from_jax(wrapped(variables))), strict=True)
    got = port_apply(pm, _t(x), train=train)
    assert got.dtype == torch.float32
    check_bf16(got, want, TRAIN_SHARE if train else EVAL_SHARE, "SharedMLP")
    if train:
        check_stats(pm.state_dict(), strip(jax_stats({"mlp": stats})), rtol=2e-3,
                    first_rtol=1e-5)
    for p in list(pm.parameters()) + list(pm.buffers()):
        assert p.dtype == torch.float32


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_batchnorm_bf16_input_matches_flax(train):
    """bf16 in, bf16 out, statistics and normalisation in f32; the running
    statistics stay f32."""
    x = mlp_input(1, (4, 50, 24)).astype(jnp.bfloat16)
    jm = jmlp.BatchNorm(24)
    variables = init_jax(jm, jnp.asarray(x), train=False)
    want, stats = jax_apply(jm, variables, jnp.asarray(x), train=train)
    assert want.dtype == jnp.bfloat16
    bn = BatchNorm(24)
    bn.load_state_dict(state_dict_from_jax(variables), strict=True)
    got = port_apply(bn, _t(np.asarray(x, np.float32)).to(BF16), train=train)
    assert got.dtype == BF16
    check_bf16(got.float(), np.asarray(want, np.float32), TRAIN_SHARE if train else 0.0, "BN")
    if train:
        check_stats(bn.state_dict(), jax_stats(stats))
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32


def test_batchnorm_bf16_is_the_f32_form_between_casts():
    """On the CPU the bf16 forms are the f32 forms of the widened input,
    rounded: train (``two_pass``) and eval, bit for bit."""
    x = _t(mlp_input(2, (300, 16))).to(BF16)
    for train in (False, True):
        a, b = BatchNorm(16), BatchNorm(16)
        for bn in (a, b):
            bn.running_mean.uniform_(-0.1, 0.1, generator=torch.Generator().manual_seed(3))
            bn.train(train)
            bn.momentum = MOMENTUM
        with torch.no_grad():
            got, want = a(x), b(x.float()).to(BF16)
        assert got.dtype == BF16 and torch.equal(got, want)
        assert torch.equal(a.running_var, b.running_var)


# ------------------------------------------------------ the bitcast gather


def test_group_points_bitcast_carries_the_bits():
    rng = np.random.RandomState(4)
    xyz = _t(rng.randn(2, 40, 3).astype(np.float32) * 100)
    feats = _t(rng.randn(2, 40, 10).astype(np.float32)).to(BF16)
    idx = _t(rng.randint(-3, 45, (2, 7, 5)).astype(np.int32))  # clamped, as the f32 gather
    gxyz, gfeat = pbq.group_points_bitcast(xyz, feats, idx)
    assert gxyz.dtype == torch.float32 and gfeat.dtype == BF16
    assert torch.equal(gxyz, pbq.group_points(xyz, idx))
    assert torch.equal(gfeat.float(), pbq.group_points(feats.float(), idx))
    with pytest.raises(ValueError, match="odd"):
        pbq.group_points_bitcast(xyz, feats[..., :9], idx)
    with pytest.raises(ValueError, match="bf16 features"):
        pbq.group_points_bitcast(xyz, feats.float(), idx)
    with pytest.raises(ValueError, match="detach"):
        pbq.group_points_bitcast(xyz.requires_grad_(), feats, idx)


def test_group_points_bitcast_gradient_matches_jax_scatter():
    """The features' gradient: the bf16 cotangent summed in f32 and rounded
    once, JAX's ``group_points`` VJP on the bf16 table
    (``ops/scatter.py``), within one bf16 ulp; no gradient to xyz."""
    from iou3dmatch_tpu.ops.ball_query import group_points as jax_group

    rng = np.random.RandomState(5)
    n, c = 30, 12
    xyz = rng.randn(2, n, 3).astype(np.float32)
    feats = rng.randn(2, n, c).astype(np.float32)
    idx = rng.randint(0, n, (2, 9, 8)).astype(np.int32)
    w = np.asarray(jnp.asarray(rng.randn(2, 9, 8, c)).astype(jnp.bfloat16), np.float32)

    def jloss(f):
        return jnp.sum(jax_group(f.astype(jnp.bfloat16), jnp.asarray(idx)).astype(jnp.float32)
                       * w)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(feats)))
    f = _t(feats).requires_grad_()
    gxyz, gfeat = pbq.group_points_bitcast(_t(xyz), f.to(BF16), _t(idx))
    (gfeat.float() * _t(w)).sum().backward()
    assert f.grad.dtype == torch.float32
    assert bf16_ulps(f.grad.numpy(), want).max() <= 1
    assert not gxyz.requires_grad


# ------------------------------------------------------------------ SA3


def sa3_inputs(seed=6, n=64, c=256):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1.5, 1.5, (2, n, 3)).astype(np.float32),
            rng.randn(2, n, c).astype(np.float32))


def sa3_pair(bitcast=True):
    """SA3's module at the tiny model's shape (64 points -> 32 centers,
    r 0.8, 16 samples, 256 features)."""
    kw = dict(npoint=32, radius=0.8, nsample=16, mlp=(256, 128, 128, 256))
    xyz, feats = sa3_inputs()
    jm = jp.PointnetSAModuleVotes(**kw, dtype=jnp.bfloat16, bitcast_gather=bitcast,
                                  exact_ball_query=True)
    variables = init_jax(jm, jnp.asarray(xyz), jnp.asarray(feats), train=False)
    pm = pp.PointnetSAModuleVotes(**kw, generator=torch.Generator().manual_seed(0), dtype=BF16,
                                  bitcast_gather=bitcast)
    pm.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jm, variables, pm, xyz, feats


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_sa_bitcast_matches_flax(train):
    jm, variables, pm, xyz, feats = sa3_pair()
    assert pm.bitcast
    want, stats = jax_apply(jm, variables, jnp.asarray(xyz), jnp.asarray(feats), train=train)
    got = port_apply(pm, _t(xyz), _t(feats), train=train)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))  # new_xyz
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))  # FPS indices
    assert got[1].dtype == torch.float32
    check_bf16(got[1], want[1], TRAIN_SHARE if train else EVAL_SHARE, "SA3 features")
    if train:
        check_stats(pm.state_dict(), jax_stats(stats), rtol=2e-3, first_rtol=1e-5)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_sa_bitcast_equals_the_f32_table_in_bf16(train):
    """The bitcast path and the f32 packed table give the same MLP input
    (the features would be cast to bf16 anyway), so the same outputs, bit
    for bit, as JAX's tests/test_ops.py:216-236 holds its two paths; the
    bitcast path's feature gradient is the f32 path's rounded to bf16 (its
    table is bf16, so its cotangent is too, ops/scatter.py:62)."""
    _, _, fast, xyz, feats = sa3_pair(bitcast=True)
    slow = pp.PointnetSAModuleVotes(npoint=32, radius=0.8, nsample=16, mlp=(256, 128, 128, 256),
                                    generator=torch.Generator().manual_seed(0), dtype=BF16)
    slow.load_state_dict(fast.state_dict())
    assert fast.bitcast and not slow.bitcast
    outs, grads = [], []
    for pm in (fast, slow):
        pm.train(train)
        set_bn_momentum(pm, MOMENTUM)
        f = _t(feats).requires_grad_()
        out = pm(_t(xyz), f)
        (out[1] * _t(np.linspace(-1, 1, out[1].numel(), dtype=np.float32)).reshape(
            out[1].shape)).sum().backward()
        outs.append(out[1].detach())
        grads.append(f.grad)
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(grads[0], grads[1].to(BF16).float())
    assert not torch.equal(grads[0], grads[1])


def test_sa_bitcast_feature_gradient_matches_jax():
    """d(sum(w * pooled)) / d(features) in eval mode: cosine > GRAD_COSINE,
    relative L2 < 0.02 (bf16 cotangents rounded apart)."""
    jm, variables, pm, xyz, feats = sa3_pair()
    w = np.random.RandomState(7).randn(2, 32, 256).astype(np.float32)

    def jloss(f):
        return jnp.sum(jm.apply(variables, jnp.asarray(xyz), f, train=False)[1] * w)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(feats)))
    pm.eval()
    f = _t(feats).requires_grad_()
    (pm(_t(xyz), f)[1] * _t(w)).sum().backward()
    got = f.grad.numpy()
    assert cosine(got, want) > GRAD_COSINE
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 0.02


# --------------------------------------------------------------- GridConv


def grid_case(seed=8, b=2, k=16, s=64, c=256):
    """Seeds of a tiny model's scale and boxes among them, headings turned."""
    rng = np.random.RandomState(seed)
    ep = {"seed_xyz": rng.uniform(-2.0, 2.0, (b, s, 3)).astype(np.float32),
          "seed_features": np.abs(rng.randn(b, s, c)).astype(np.float32)}
    center = rng.uniform(-1.5, 1.5, (b, k, 3)).astype(np.float32)
    size = rng.uniform(0.1, 0.8, (b, k, 3)).astype(np.float32)
    heading = rng.uniform(-np.pi, np.pi, (b, k)).astype(np.float32)
    return center, size, heading, ep


def grid_pair(f32=False):
    cfg = get_config("scannet")
    dims = dict(num_class=cfg.num_class, num_heading_bin=cfg.num_heading_bin,
                num_size_cluster=cfg.num_size_cluster)
    center, size, heading, ep = grid_case()
    jm = jgrid.GridConv(**dims, dtype=None if f32 else jnp.bfloat16)
    variables = init_jax(jm, jnp.asarray(center), jnp.asarray(size), jnp.asarray(heading),
                         {k: jnp.asarray(v) for k, v in ep.items()}, train=False)
    pm = pgrid.GridConv(**dims, generator=torch.Generator().manual_seed(0),
                        dtype=None if f32 else BF16)
    pm.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jm, variables, pm, (center, size, heading, ep)


def flat_grid(pm, center, size, heading):
    """The port's (B, K * 64, 3) grid points, as GridConv.forward builds them."""
    from iou3dmatch_tpu_torch.geometry.boxes import rot_gpu

    rel = pm.offsets[None, None] * _t(size)[:, :, None, :]
    grid = torch.einsum("bkgc,bkdc->bkgd", rel, rot_gpu(_t(heading))) + _t(center)[:, :, None]
    return grid.reshape(grid.shape[0], -1, 3)


# JAX's bf16 three_nn is approx_min_k on a mean-centred matmul-form d2
# (ops/interpolate.py:73-106), which XLA's CPU lowers to an exact top-k of
# that d2; its error, at most a few f32 ulps of |u|^2 + |k|^2 per term, is
# bounded here by 2^-20 (|u|^2 + |k|^2) of the centred query and seed.
MATMUL_D2_REL = 2.0 ** -20


def test_grid_conv_bf16_neighbours_against_jax_approx():
    """The port's exact three_nn against JAX's bf16 picks: the same three
    neighbours wherever the third and fourth nearest d2 are further apart
    than the matmul form's error bound, in the same order wherever every
    consecutive pair is; their distances within 4 f32 ulps of the largest
    centred coordinate. At most 1 % of the rows fall under the bound."""
    from iou3dmatch_tpu.ops.interpolate import three_nn as jax_three_nn

    _, _, pm, (center, size, heading, ep) = grid_pair()
    grid = flat_grid(pm, center, size, heading)
    seeds = _t(ep["seed_xyz"])
    jd, ji = (np.asarray(a) for a in jax_three_nn(jnp.asarray(grid.numpy()), jnp.asarray(
        ep["seed_xyz"]), exact=False))
    pd, pi = (a.numpy() for a in three_nn(grid, seeds))
    u, k = grid.numpy().astype(np.float64), ep["seed_xyz"].astype(np.float64)
    mu = k.mean(1, keepdims=True)
    u, k = u - mu, k - mu
    d2 = ((u[:, :, None] - k[:, None]) ** 2).sum(-1)
    srt = np.sort(d2, -1)
    bound = MATMUL_D2_REL * ((u ** 2).sum(-1) + (k ** 2).sum(-1).max(1, keepdims=True))
    gaps = np.diff(srt[..., :4], axis=-1)  # (B, q, 3): 2nd-1st, 3rd-2nd, 4th-3rd
    clear_set = gaps[..., 2] > bound
    clear_order = (gaps > bound[..., None]).all(-1)
    assert clear_set.mean() > 0.99 and clear_order.mean() > 0.99
    np.testing.assert_array_equal(np.sort(pi, -1)[clear_set], np.sort(ji, -1)[clear_set])
    np.testing.assert_array_equal(pi[clear_order], ji[clear_order])
    ulp = np.spacing(np.float32(np.abs(u).max()))
    np.testing.assert_allclose(pd[clear_order], jd[clear_order], rtol=0, atol=4 * ulp)


def test_grid_conv_bf16_interpolation_matches_jax():
    """The interpolated rows on JAX's picks: bf16 seed xyz, bf16 weights,
    bf16 features, f32 sums rounded to bf16; within one bf16 ulp of JAX's
    one-hot products everywhere (the f32 sums run in another order)."""
    from iou3dmatch_tpu.ops.interpolate import three_nn as jax_three_nn

    jm, variables, pm, (center, size, heading, ep) = grid_pair()
    grid = flat_grid(pm, center, size, heading)
    _, idx = jax_three_nn(jnp.asarray(grid.numpy()), jnp.asarray(ep["seed_xyz"]), exact=False)
    want = jm.apply(variables, jnp.asarray(grid.numpy()), jnp.asarray(ep["seed_xyz"]),
                    jnp.asarray(ep["seed_features"]), idx, method=jgrid.GridConv._interp_onehot)
    assert want.dtype == jnp.bfloat16
    got = pm.interpolate(grid, _t(ep["seed_xyz"]), _t(ep["seed_features"]), _t(idx))
    assert got.dtype == BF16
    assert bf16_ulps(got.float().numpy(), np.asarray(want, np.float32)).max() <= 1


def grid_forward(jm, variables, pm, case, train):
    center, size, heading, ep = case
    jep = {k: jnp.asarray(v) for k, v in ep.items()}
    want, _ = jax_apply(jm, variables, jnp.asarray(center), jnp.asarray(size),
                        jnp.asarray(heading), jep, train=train)
    got = port_apply(pm, _t(center), _t(size), _t(heading),
                     {k: _t(v) for k, v in ep.items()}, train=train)
    return got["iou_scores"].numpy(), np.asarray(want["iou_scores"])


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_grid_conv_bf16_iou_scores_match_jax(train):
    """The f32 head on the bf16 branch: the IoU logits within 1e-2 of their
    largest magnitude (a few bf16 ulps of the pooled features), where the
    f32 GridConv's differ from the bf16 one's by more."""
    jm, variables, pm, case = grid_pair()
    got, want = grid_forward(jm, variables, pm, case, train)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < 1e-2 * scale
    jm32, _, pm32, _ = grid_pair(f32=True)
    pm32.load_state_dict(pm.state_dict())
    f32_got, _ = grid_forward(jm32, variables, pm32, case, train)
    assert np.abs(f32_got - want).max() > np.abs(got - want).max()


def test_grid_conv_bf16_box_gradient_matches_jax():
    """d(sum(w * iou_scores)) / d(center, size, heading) in eval mode, the
    gradient IoU optimisation follows: through the distances and the bf16
    casts in both packages; cosine > 0.99 each."""
    jm, variables, pm, (center, size, heading, ep) = grid_pair()
    w = np.random.RandomState(9).randn(*center.shape[:2], 18).astype(np.float32)
    jep = {k: jnp.asarray(v) for k, v in ep.items()}

    def jloss(c, s, h):
        return jnp.sum(jm.apply(variables, c, s, h, dict(jep), train=False)["iou_scores"] * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(center), jnp.asarray(size),
                                              jnp.asarray(heading))
    pm.eval()
    boxes = [_t(x).requires_grad_() for x in (center, size, heading)]
    ep_t = {k: _t(v) for k, v in ep.items()}
    (pm(*boxes, ep_t)["iou_scores"] * _t(w)).sum().backward()
    for name, b, g in zip(("center", "size", "heading"), boxes, want):
        assert cosine(b.grad.numpy(), np.asarray(g)) > 0.99, name


# --------------------------------------------------------------- backbone


@pytest.fixture
def exact_jax_ball_query(monkeypatch):
    """JAX's backbone SA layers take their exact ball query."""
    real = jp.ball_query
    monkeypatch.setattr(jp, "ball_query",
                        lambda r, ns, xyz, new_xyz, exact=False: real(r, ns, xyz, new_xyz,
                                                                      exact=True))


def backbone_scenes(seed=11, b=2, n=2048):
    rng = np.random.RandomState(seed)
    pc = np.zeros((b, n, 4), np.float32)
    pc[..., 0:3] = rng.uniform(-3.0, 3.0, (b, n, 3))
    pc[..., 3] = pc[..., 2] - pc[..., 2].min(axis=1, keepdims=True)
    return pc


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_backbone_bf16_matches_flax(train, exact_jax_ball_query):
    """Every index equal (FPS, the ball queries and three_nn read f32
    xyz); the seed features within the bf16 bounds in eval mode. In train
    mode the tiny model's batch statistics over a few hundred rows amplify
    a bf16 flip (an input moved by 1e-5 moves them as much), so there the
    seeds are held to a correlation > 0.99."""
    from iou3dmatch_tpu.models.backbone import Pointnet2Backbone
    from iou3dmatch_tpu_torch.models.backbone import Pointnet2Backbone as PortBackbone
    from iou3dmatch_tpu_torch.models.factory import TINY_SA_NPOINTS

    pc = backbone_scenes()
    jm = Pointnet2Backbone(input_feature_dim=1, dtype=jnp.bfloat16, sa_npoints=TINY_SA_NPOINTS)
    variables = init_jax(jm, jnp.asarray(pc), train=False)
    want, _ = jax_apply(jm, variables, jnp.asarray(pc), train=train)
    pm = PortBackbone(1, torch.Generator().manual_seed(0), sa_npoints=TINY_SA_NPOINTS, dtype=BF16)
    pm.load_state_dict({k[len("backbone_net."):] if k.startswith("backbone_net.") else k: v
                        for k, v in state_dict_from_jax(variables).items()}, strict=True)
    assert pm.sa3.bitcast and pm.sa4.bitcast and not pm.sa1.bitcast and not pm.sa2.bitcast
    got = port_apply(pm, _t(pc), train=train)
    for k in ("sa1_inds", "sa2_inds", "fp2_inds", "sa1_xyz", "sa2_xyz", "sa3_xyz", "sa4_xyz"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in ("sa1_features", "sa2_features", "sa3_features", "sa4_features", "fp2_features"):
        a, b = got[k].numpy(), np.asarray(want[k])
        assert a.dtype == np.float32
        if train:
            assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.99, k
        else:
            check_bf16(a, b, EVAL_SHARE, k, scale_ulps=2.0)


# ------------------------------------------------- parameters stay float32


@pytest.mark.parametrize("f32_gridconv", [False, True])
def test_bf16_model_keeps_f32_parameters_and_state_dict(f32_gridconv):
    """The modules that follow the dtype (JAX tests/test_model.py:402-420),
    f32 parameters, BN statistics and gradients after a train-mode
    backward, and one state dict for both dtypes: an f32 model's loads into
    the bf16 model and back, bit for bit."""
    pm, _ = build_votenet(tiny=True, device="cpu", compute_dtype="bfloat16",
                          f32_gridconv=f32_gridconv)
    bb = pm.backbone_net
    for mod in (bb.sa1, bb.sa2, bb.sa3, bb.sa4):
        assert mod.mlp_module.dtype == BF16
    assert bb.fp1.mlp.dtype == bb.fp2.mlp.dtype == BF16
    assert pm.grid_conv.dtype == pm.grid_conv.mlp_before_iou.dtype == (
        None if f32_gridconv else BF16)
    assert pm.pnet.vote_aggregation.mlp_module.dtype is None
    assert pm.compute_dtype == BF16
    f32, _ = build_votenet(tiny=True, device="cpu", generator=torch.Generator().manual_seed(1))
    pm.load_state_dict(f32.state_dict(), strict=True)
    back, _ = build_votenet(tiny=True, device="cpu")
    back.load_state_dict(pm.state_dict(), strict=True)
    for k, v in f32.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    pm.train()
    set_bn_momentum(pm, MOMENTUM)
    ep = pm.forward_with_pred_jitter(_t(backbone_scenes()), generator=torch.Generator())
    (ep["objectness_scores"].sum() + ep["iou_scores"].sum()).backward()
    for k, p in pm.named_parameters():
        assert p.dtype == torch.float32 and p.grad is not None and p.grad.dtype == torch.float32, k
    for k, b in pm.named_buffers():
        assert b.dtype == torch.float32, k
    for k in ("objectness_scores", "center", "iou_scores", "iou_scores_jitter", "seed_features"):
        assert ep[k].dtype == torch.float32, k


def test_compute_dtype_names():
    """JAX's names: None (f32) and "bfloat16"; anything else raises."""
    assert build_votenet(tiny=True, device="cpu")[0].compute_dtype == torch.float32
    assert build_votenet(tiny=True, device="cpu", compute_dtype="bfloat16")[0].compute_dtype == BF16
    for name in ("float16", torch.bfloat16):
        with pytest.raises(ValueError, match="compute_dtype"):
            build_votenet(tiny=True, device="cpu", compute_dtype=name)
