"""The PointNet++ modules VoteNet leaves unused, against the flax modules.

``uniform_resample_idx``, ``PointnetSAModuleVotes``' pooling, xyz and
resampling options, ``QueryAndGroup``, ``GroupAll``, ``PointnetSAModuleMSG``
and its ``PointnetSAModule`` factory, ``PointnetSAModuleMSGVotes``,
``PointnetLFPModuleMSG`` and ``RandomDropout``: each JAX module is
initialised, its BN running statistics perturbed away from (0, 1), and its
weights carried into the port's module by ``state_dict_from_jax`` (and by
the JAX package's ``export_state_dict``, which must load too). Both then
take the same seeded inputs: 2 clouds of 256 points in [-1, 1]^3 with 3
feature channels. Every JAX module runs its exact ball query
(``exact_ball_query=True``; its default is approximate, ROADMAP Queue 3).

JAX's random draws cannot be made in torch, so the port is given them:
``uniform_resample_from`` takes JAX's ``jax.random.uniform(key, idx.shape)``
(the module tests record the key each JAX call of ``uniform_resample_idx``
gets and hand the port the same draws), and ``RandomDropout`` JAX's theta
and mask draws.

Tolerances: indices and resampled indices equal; outputs within atol 1e-4
(``tests/test_torch_models.py``'s: the same f32 math summed in another
order); BN running statistics after a train-mode call within 1e-5;
gradients of parameters and input features within 1e-4 of the largest
entry; dropout equal.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.tree_util as jtu  # noqa: E402
import torch  # noqa: E402

from iou3dmatch_tpu_torch.models import pointnet2 as pp  # noqa: E402
from iou3dmatch_tpu_torch.models.mlp import RandomDropout, set_bn_momentum  # noqa: E402
from iou3dmatch_tpu_torch.ops import ball_query  # noqa: E402
from iou3dmatch_tpu_torch.train.torch_import import state_dict_from_jax  # noqa: E402

jp = pytest.importorskip("iou3dmatch_tpu.models.pointnet2")
torch.set_num_threads(1)
ATOL = 1e-4
STATS_ATOL = 1e-5
GRAD_RTOL = 1e-4
MOMENTUM = 0.1
B, N, C = 2, 256, 3


def cloud(seed, n=N, c=C):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1.0, 1.0, (B, n, 3)).astype(np.float32),
            rng.randn(B, n, c).astype(np.float32))


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


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _close(got, want, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol, err_msg=what)


def _equal(got, want, what=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=what)


class Recorder:
    """Stands in for JAX's ``uniform_resample_idx`` and keeps the uniform
    draws each call makes from the key it gets; ``port`` stands in for the
    port's wrapper and hands it those draws in order."""

    def __init__(self):
        self.draws = []
        self.real = jp.uniform_resample_idx

    def jax(self, idx, rng):
        self.draws.append(np.asarray(jax.random.uniform(rng, idx.shape)))
        return self.real(idx, rng)

    def port(self):
        draws = iter(list(self.draws))
        return lambda idx, generator: pp.uniform_resample_from(idx, _t(next(draws)))


@pytest.fixture
def recorder(monkeypatch):
    rec = Recorder()
    monkeypatch.setattr(jp, "uniform_resample_idx", rec.jax)
    return rec


def init_jax(module, *args, seed=0, **kw):
    rngs = {"params": jax.random.PRNGKey(seed), "grouping": jax.random.PRNGKey(seed + 1)}
    variables = module.init(rngs, *args, **kw)
    return perturb_batch_stats(jax.tree.map(np.asarray, dict(variables)))


def load(pm, variables):
    pm.load_state_dict(state_dict_from_jax(variables), strict=True)
    return pm


def run_jax(module, variables, *args, train):
    """(outputs, batch stats after the call or None)."""
    rngs = {"grouping": jax.random.PRNGKey(9)}
    if train:
        out, mut = module.apply(variables, *args, train=True, momentum=MOMENTUM,
                                mutable=["batch_stats"], rngs=rngs)
        return out, mut["batch_stats"]
    return module.apply(variables, *args, train=False, rngs=rngs), None


def run_port(pm, *args, train, **kw):
    pm.train(train)
    set_bn_momentum(pm, MOMENTUM)
    with torch.no_grad():
        return pm(*args, **kw)


def check_stats(pm, stats):
    """The port's running statistics against JAX's after a train-mode call."""
    if stats is None:
        return
    want = state_dict_from_jax({"batch_stats": jax.tree.map(np.asarray, stats)})
    got = pm.state_dict()
    assert want
    for k, v in want.items():
        _close(got[k], v, atol=STATS_ATOL, what=k)


# ---------------------------------------------------------------- resampling


def _ball_idx(seed):
    xyz, _ = cloud(seed)
    return ball_query(0.45, 16, _t(xyz), _t(xyz[:, :32])).numpy()


@pytest.mark.parametrize("source", ["random", "ball_query"])
def test_uniform_resample_matches_jax_bit_for_bit(source):
    if source == "random":
        idx = np.random.RandomState(2).randint(0, 6, size=(3, 5, 8)).astype(np.int32)
        idx[0, 0, :] = 4  # a region of one point, as a ball query fills it
    else:
        idx = _ball_idx(3)
        assert (idx[..., -1] == idx[..., 0]).any() and (idx[..., -1] != idx[..., 0]).any()
    key = jax.random.PRNGKey(5)
    want_idx, want_cnt = jax.jit(jp.uniform_resample_idx)(jnp.asarray(idx), key)
    u = np.asarray(jax.random.uniform(key, idx.shape))
    got_idx, got_cnt = pp.uniform_resample_from(_t(idx), _t(u))
    assert got_idx.dtype == torch.int32 and got_cnt.dtype == torch.float32
    _equal(got_idx, want_idx)
    _equal(got_cnt, want_cnt)


def test_uniform_resample_draws_from_the_generator_given():
    idx = _t(_ball_idx(4))
    got = pp.uniform_resample_idx(idx, torch.Generator().manual_seed(3))
    u = torch.rand(idx.shape, generator=torch.Generator().manual_seed(3))
    want = pp.uniform_resample_from(idx, u)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="explicit generator"):
        pp.uniform_resample_idx(idx, None)


# --------------------------------------------------------------- SA options

SA_CASES = {
    "max": dict(),
    "avg": dict(pooling="avg"),
    "rbf": dict(pooling="rbf"),
    "rbf_sigma": dict(pooling="rbf", sigma=0.3),
    "no_use_xyz": dict(use_xyz=False),
    "no_normalize": dict(normalize_xyz=False, pooling="rbf"),
    "xyz_only": dict(features=False),
    "sample_uniformly": dict(sample_uniformly=True, ret_unique_cnt=True),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", sorted(SA_CASES))
def test_sa_votes_options_match_flax(case, train, recorder, monkeypatch):
    kw = dict(SA_CASES[case])
    with_features = kw.pop("features", True)
    xyz, feats = cloud(11)
    feats = feats if with_features else None
    mlp = (C if with_features else 0, 16, 32)
    jm = jp.PointnetSAModuleVotes(npoint=32, radius=0.4, nsample=16, mlp=mlp,
                                  exact_ball_query=True, **kw)
    variables = init_jax(jm, _j(xyz), _j(feats), train=False)
    recorder.draws.clear()
    want, stats = run_jax(jm, variables, _j(xyz), _j(feats), train=train)
    pm = load(pp.PointnetSAModuleVotes(npoint=32, radius=0.4, nsample=16, mlp=mlp,
                                       generator=torch.Generator().manual_seed(0), **kw),
              variables)
    monkeypatch.setattr(pp, "uniform_resample_idx", recorder.port())
    got = run_port(pm, _t(xyz), _t(feats), train=train)
    assert len(got) == len(want) == (4 if kw.get("ret_unique_cnt") else 3)
    _close(got[0], want[0], what="new_xyz")
    _close(got[1], want[1], what="features")
    _equal(got[2], want[2])
    if kw.get("ret_unique_cnt"):
        _equal(got[3], want[3])
        assert (got[3] >= 1).all()
    check_stats(pm, stats)


def test_sa_votes_refuses_what_jax_refuses():
    g = torch.Generator()
    with pytest.raises(ValueError, match="pooling"):
        pp.PointnetSAModuleVotes(npoint=8, radius=0.4, nsample=8, mlp=(3, 8), generator=g,
                                 pooling="min")
    with pytest.raises(ValueError, match="ret_unique_cnt"):
        pp.PointnetSAModuleVotes(npoint=8, radius=0.4, nsample=8, mlp=(3, 8), generator=g,
                                 ret_unique_cnt=True)
    with pytest.raises(ValueError, match="sentinel"):
        pp.PointnetSAModuleVotes(npoint=8, radius=0.4, nsample=8, mlp=(3, 8), generator=g)(
            torch.zeros(1, 16, 3), None, "suffix")


# ------------------------------------------------------ QueryAndGroup, GroupAll

QG_CASES = {
    "xyz_and_features": dict(),
    "features_only": dict(use_xyz=False),
    "xyz_only": dict(features=False),
    "normalized_with_xyz": dict(normalize_xyz=True, ret_grouped_xyz=True),
    "sample_uniformly": dict(sample_uniformly=True, ret_unique_cnt=True, ret_grouped_xyz=True),
}


@pytest.mark.parametrize("case", sorted(QG_CASES))
def test_query_and_group_matches_flax(case, recorder, monkeypatch):
    kw = dict(QG_CASES[case])
    with_features = kw.pop("features", True)
    xyz, feats = cloud(12)
    feats = feats if with_features else None
    new_xyz = xyz[:, :24]
    jm = jp.QueryAndGroup(radius=0.4, nsample=16, exact_ball_query=True, **kw)
    args = (_j(xyz), _j(new_xyz), _j(feats))
    recorder.draws.clear()
    want = jm.apply({}, *args, rngs={"grouping": jax.random.PRNGKey(6)})
    monkeypatch.setattr(pp, "uniform_resample_idx", recorder.port())
    got = pp.QueryAndGroup(radius=0.4, nsample=16, **kw)(_t(xyz), _t(new_xyz), _t(feats))
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)


def test_query_and_group_without_features_or_xyz_raises_in_both():
    xyz, _ = cloud(13)
    with pytest.raises(AssertionError):
        jm = jp.QueryAndGroup(radius=0.4, nsample=8, use_xyz=False, exact_ball_query=True)
        jm.apply({}, _j(xyz), _j(xyz[:, :8]))
    with pytest.raises(ValueError, match="not use xyz"):
        pp.QueryAndGroup(radius=0.4, nsample=8, use_xyz=False)(_t(xyz), _t(xyz[:, :8]))


@pytest.mark.parametrize("use_xyz", [True, False])
@pytest.mark.parametrize("with_features", [True, False])
def test_group_all_matches_flax(use_xyz, with_features):
    xyz, feats = cloud(14)
    feats = feats if with_features else None
    want = jp.GroupAll(use_xyz=use_xyz).apply({}, _j(xyz), None, _j(feats))
    got = pp.GroupAll(use_xyz=use_xyz)(_t(xyz), None, _t(feats))
    assert tuple(got.shape) == want.shape
    _equal(got, want)


# ----------------------------------------------------------- MSG, MSG-votes

MSG = dict(radii=(0.3, 0.5), nsamples=(8, 16), mlps=((C, 16, 16), (C, 16, 32)))
MSG_CASES = {
    "msg": (jp.PointnetSAModuleMSG, pp.PointnetSAModuleMSG, dict(npoint=24, **MSG)),
    "msg_no_use_xyz": (jp.PointnetSAModuleMSG, pp.PointnetSAModuleMSG,
                       dict(npoint=24, use_xyz=False, **MSG)),
    "sa_module": (jp.PointnetSAModule, pp.PointnetSAModule,
                  dict(npoint=24, radius=0.4, nsample=16, mlp=(C, 16, 16))),
    "group_all": (jp.PointnetSAModule, pp.PointnetSAModule, dict(mlp=(C, 16, 32))),
    "group_all_msg": (jp.PointnetSAModuleMSG, pp.PointnetSAModuleMSG,
                      dict(npoint=None, radii=(None, None), nsamples=(None, None),
                           mlps=((C, 8), (C, 16)))),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", sorted(MSG_CASES))
def test_msg_modules_match_flax(case, train):
    jcls, pcls, kw = MSG_CASES[case]
    xyz, feats = cloud(15)
    jm = jcls(exact_ball_query=True, **kw)
    variables = init_jax(jm, _j(xyz), _j(feats), train=False)
    want, stats = run_jax(jm, variables, _j(xyz), _j(feats), train=train)
    pm = load(pcls(generator=torch.Generator().manual_seed(0), **kw), variables)
    got = run_port(pm, _t(xyz), _t(feats), train=train)
    assert tuple(got[1].shape) == want[1].shape
    _close(got[0], want[0], what="new_xyz")
    _close(got[1], want[1], what="features")
    check_stats(pm, stats)


MSG_VOTES_CASES = {
    "own_inds": dict(),
    "given_inds": dict(inds=True),
    "sample_uniformly": dict(sample_uniformly=True),
    "no_use_xyz": dict(use_xyz=False),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", sorted(MSG_VOTES_CASES))
def test_msg_votes_matches_flax(case, train, recorder, monkeypatch):
    kw = dict(MSG_VOTES_CASES[case])
    given = kw.pop("inds", False)
    xyz, feats = cloud(16)
    inds = np.random.RandomState(1).randint(0, N, (B, 24)).astype(np.int32) if given else None
    jm = jp.PointnetSAModuleMSGVotes(npoint=24, exact_ball_query=True, **MSG, **kw)
    variables = init_jax(jm, _j(xyz), _j(feats), _j(inds), train=False)
    recorder.draws.clear()
    want, stats = run_jax(jm, variables, _j(xyz), _j(feats), _j(inds), train=train)
    pm = load(pp.PointnetSAModuleMSGVotes(npoint=24, generator=torch.Generator().manual_seed(0),
                                          **MSG, **kw), variables)
    monkeypatch.setattr(pp, "uniform_resample_idx", recorder.port())
    got = run_port(pm, _t(xyz), _t(feats), _t(inds), train=train)
    if kw.get("sample_uniformly"):
        assert len(recorder.draws) == 2  # one draw for each scale
    _equal(got[2], want[2])
    if given:
        _equal(got[2], inds)
    _close(got[0], want[0], what="new_xyz")
    _close(got[1], want[1], what="features")
    check_stats(pm, stats)


def test_msg_votes_group_all_matches_flax():
    xyz, feats = cloud(17)
    kw = dict(npoint=None, radii=(None,), nsamples=(None,), mlps=((C, 16, 32),))
    jm = jp.PointnetSAModuleMSGVotes(**kw)
    variables = init_jax(jm, _j(xyz), _j(feats), train=False)
    want, _ = run_jax(jm, variables, _j(xyz), _j(feats), train=False)
    got = run_port(load(pp.PointnetSAModuleMSGVotes(generator=torch.Generator(), **kw),
                        variables), _t(xyz), _t(feats), train=False)
    assert want[0] is None and want[2] is None and got[0] is None and got[2] is None
    _close(got[1], want[1])


# ---------------------------------------------------------------------- LFP

LFP = dict(radii=(0.4, 0.6), nsamples=(8, 16), mlps=((8, 16, 16), (8, 16, 32)),
           post_mlp=(16 + 4, 24))


def lfp_inputs(seed):
    rng = np.random.RandomState(seed)
    xyz1 = rng.uniform(-1.0, 1.0, (B, 128, 3)).astype(np.float32)
    xyz2 = xyz1[:, :40].copy()
    return (xyz2, xyz1, rng.randn(B, 40, 4).astype(np.float32),
            rng.randn(B, 128, 8).astype(np.float32))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("with_features2", [True, False])
def test_lfp_matches_flax(with_features2, train):
    xyz2, xyz1, f2, f1 = lfp_inputs(18)
    kw = dict(LFP)
    if not with_features2:
        f2 = None
        kw["post_mlp"] = (16, 24)
    jm = jp.PointnetLFPModuleMSG(exact_ball_query=True, **kw)
    args = (xyz2, xyz1, f2, f1)
    variables = init_jax(jm, *map(_j, args), train=False)
    want, stats = run_jax(jm, variables, *map(_j, args), train=train)
    pm = load(pp.PointnetLFPModuleMSG(generator=torch.Generator().manual_seed(0), **kw),
              variables)
    got = run_port(pm, *map(_t, args), train=train)
    assert tuple(got.shape) == want.shape == (B, 40, 48)
    _close(got, want)
    check_stats(pm, stats)


# ---------------------------------------------------------------- gradients


def _grad_case(name):
    if name == "msg":
        xyz, feats = cloud(19)
        return (jp.PointnetSAModuleMSG(npoint=24, exact_ball_query=True, **MSG),
                pp.PointnetSAModuleMSG(npoint=24, generator=torch.Generator(), **MSG),
                [xyz, feats], [1], 1)
    xyz2, xyz1, f2, f1 = lfp_inputs(20)
    return (jp.PointnetLFPModuleMSG(exact_ball_query=True, **LFP),
            pp.PointnetLFPModuleMSG(generator=torch.Generator(), **LFP),
            [xyz2, xyz1, f2, f1], [2, 3], None)


@pytest.mark.parametrize("name", ["msg", "lfp"])
def test_msg_and_lfp_gradients_match_flax(name):
    """Train mode: the gradient of a random projection of the output with
    respect to every parameter and to the input features (the features of
    the grouped points; LFP's centers' features too)."""
    jm, pm, args, feat_pos, out_index = _grad_case(name)
    variables = init_jax(jm, *map(_j, args), train=False)
    out_shape = jax.eval_shape(lambda: jm.apply(variables, *map(_j, args), train=False))
    out_shape = out_shape[out_index] if out_index is not None else out_shape
    w = np.random.RandomState(21).randn(*out_shape.shape).astype(np.float32)

    def loss(params, *feats):
        full = list(map(_j, args))
        for i, f in zip(feat_pos, feats):
            full[i] = f
        out, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, *full,
                          train=True, momentum=MOMENTUM, mutable=["batch_stats"])
        out = out[out_index] if out_index is not None else out
        return jnp.sum(out * w)

    grads = jax.grad(loss, argnums=tuple(range(1 + len(feat_pos))))(
        variables["params"], *[_j(args[i]) for i in feat_pos])
    want = state_dict_from_jax({"params": jax.tree.map(np.asarray, grads[0])})
    load(pm, variables)
    pm.train()
    set_bn_momentum(pm, MOMENTUM)
    targs = [_t(a) for a in args]
    for i in feat_pos:
        targs[i].requires_grad_(True)
    out = pm(*targs)
    out = out[out_index] if out_index is not None else out
    (out * _t(w)).sum().backward()
    got = {k: p.grad for k, p in pm.named_parameters()}
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.abs(v.numpy()).max() > 0, k
        _close(got[k], v, atol=GRAD_RTOL * float(np.abs(v.numpy()).max()), what=k)
    for i, g in zip(feat_pos, grads[1:]):
        g = np.asarray(g)
        assert np.abs(g).max() > 0
        _close(targs[i].grad, g, atol=GRAD_RTOL * float(np.abs(g).max()), what=f"input {i}")


# --------------------------------------------------------------- dropout


def _jax_dropout_draws(key, p, c):
    """The draws RandomDropout makes from the 'dropout' stream: the key a
    top-level module's first ``make_rng`` gives, split into theta's and the
    mask's."""
    from flax import linen as nn

    class Probe(nn.Module):
        @nn.compact
        def __call__(self):
            return self.make_rng("dropout")

    rng = Probe().apply({}, rngs={"dropout": key})
    theta_rng, mask_rng = jax.random.split(rng)
    return (np.asarray(jax.random.uniform(theta_rng, (), minval=0.0, maxval=p)),
            np.asarray(jax.random.uniform(mask_rng, (c,))))


@pytest.mark.parametrize("p", [0.5, 0.9])
def test_random_dropout_matches_flax_given_its_draws(p):
    from iou3dmatch_tpu.models.mlp import RandomDropout as JaxDropout

    x = np.random.RandomState(22).randn(2, 64, 32).astype(np.float32) + 3.0
    key = jax.random.PRNGKey(7)
    jm = JaxDropout(p=p)
    want = np.asarray(jm.apply({}, jnp.asarray(x), train=True, rngs={"dropout": key}))
    theta, u = _jax_dropout_draws(key, p, 32)
    mod = RandomDropout(p).train()
    got = mod(_t(x), draws=(_t(theta), _t(u)))
    _equal(got, want)
    kept = torch.from_numpy(u >= theta)
    assert 0 < int(kept.sum()) < 32  # some channels of each kind
    assert torch.equal(got[..., kept], _t(x)[..., kept])  # kept values are not rescaled
    assert (got[..., ~kept] == 0).all()  # whole channels zeroed
    assert torch.equal(mod.eval()(_t(x)), _t(x))
    _equal(jm.apply({}, jnp.asarray(x), train=False), x)


def test_random_dropout_draws_theta_then_the_mask_from_the_generator():
    x = torch.randn(4, 16, 64)
    mod = RandomDropout(0.5).train()
    got = mod(x, generator=torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(3)
    theta = torch.rand((), generator=g) * 0.5
    u = torch.rand(64, generator=g)
    assert torch.equal(got, mod(x, draws=(theta, u)))
    with pytest.raises(ValueError, match="explicit generator"):
        mod(x)
    assert torch.equal(RandomDropout(0.0).train()(x), x)


# ----------------------------------------------------------- weights across


WEIGHT_CASES = {
    "sa_votes_rbf": lambda: (jp.PointnetSAModuleVotes(
        npoint=16, radius=0.4, nsample=8, mlp=(C, 16), pooling="rbf", exact_ball_query=True),
        dict(npoint=16, radius=0.4, nsample=8, mlp=(C, 16), pooling="rbf"),
        pp.PointnetSAModuleVotes, "sa"),
    "msg": lambda: (jp.PointnetSAModuleMSG(npoint=24, exact_ball_query=True, **MSG),
                    dict(npoint=24, **MSG), pp.PointnetSAModuleMSG, "sa"),
    "msg_votes": lambda: (jp.PointnetSAModuleMSGVotes(npoint=24, exact_ball_query=True, **MSG),
                          dict(npoint=24, **MSG), pp.PointnetSAModuleMSGVotes, "sa"),
    "lfp": lambda: (jp.PointnetLFPModuleMSG(exact_ball_query=True, **LFP), dict(LFP),
                    pp.PointnetLFPModuleMSG, "lfp"),
}


@pytest.mark.parametrize("case", sorted(WEIGHT_CASES))
def test_jax_export_and_state_dict_from_jax_both_load_strictly(case):
    """``state_dict_from_jax`` and the JAX package's ``export_state_dict``
    give the same keys and values for each module, and both load into the
    port's module with ``strict=True``."""
    from iou3dmatch_tpu.train.torch_import import export_state_dict

    jm, kw, pcls, kind = WEIGHT_CASES[case]()
    args = lfp_inputs(23) if kind == "lfp" else cloud(23)
    variables = init_jax(jm, *map(_j, args), train=False)
    ours = state_dict_from_jax(variables)
    theirs = {k: torch.from_numpy(np.array(v, np.float32))
              for k, v in export_state_dict(variables).items()}
    assert set(ours) == set(theirs)
    for k in ours:
        assert ours[k].shape == theirs[k].shape, k
        assert torch.equal(ours[k], theirs[k]), k
    pm = pcls(generator=torch.Generator(), **kw)
    pm.load_state_dict(theirs, strict=True)
    pm.load_state_dict(ours, strict=True)
    if kind == "lfp":
        assert any(k.startswith("post_mlp1.dense0.") for k in ours)
        assert any(k.startswith("mlp1.layer1.conv.") for k in ours)
