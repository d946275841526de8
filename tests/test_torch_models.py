"""The port's modules against the JAX package's flax modules.

One tiny JAX VoteNet (ScanNet config, ``tiny=True``) is initialised per
file, its BN running statistics are perturbed away from (0, 1), and its
weights are carried into the port's model by ``state_dict_from_jax``. Each
submodule of both models then takes the same seeded inputs. Indices must
be identical; float outputs agree within atol 1e-4 (the same f32 math,
summed in another order: CPU matmuls in XLA and in PyTorch, and GridConv's
one-hot-matmul interpolation on the JAX side against the port's gather).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.tree_util as jtu  # noqa: E402
import torch  # noqa: E402

from iou3dmatch_tpu_torch.models.factory import build_votenet  # noqa: E402
from iou3dmatch_tpu_torch.train.steps import KEEP, make_eval_forward  # noqa: E402
from iou3dmatch_tpu_torch.train.torch_import import state_dict_from_jax  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-4


def scenes(seed, b=2, n=2048):
    """Uniform points in [-3, 3]^3 with the height channel z - min z
    (the recipe of tests/test_torch_import.py)."""
    rng = np.random.RandomState(seed)
    pc = np.zeros((b, n, 4), np.float32)
    pc[..., 0:3] = rng.uniform(-3.0, 3.0, (b, n, 3))
    pc[..., 3] = pc[..., 2] - pc[..., 2].min(axis=1, keepdims=True)
    return pc


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


@pytest.fixture(scope="module")
def pair():
    from iou3dmatch_tpu.models.factory import build_votenet as build_jax

    jm, cfg = build_jax("scannet", tiny=True)
    pc = scenes(11)
    variables = jax.jit(lambda x: jm.init({"params": jax.random.PRNGKey(4)}, x, train=False))(
        jnp.asarray(pc))
    variables = perturb_batch_stats(jax.tree.map(np.asarray, variables))
    pm, _ = build_votenet("scannet", tiny=True, device="cpu")
    pm.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jm.bind(variables), pm, variables, jm, cfg


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=ATOL)


def _equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("inds", ["fps", "prefix", "given"])
def test_sa_module_matches_flax(pair, inds):
    bound, pm, *_ = pair
    rng = np.random.RandomState(3)
    if inds == "fps":
        jsa, psa, n, c = bound.backbone_net.sa1, pm.backbone_net.sa1, 2048, 1
    else:
        jsa, psa, n, c = bound.backbone_net.sa2, pm.backbone_net.sa2, 128, 128
    xyz = rng.uniform(-3, 3, (2, n, 3)).astype(np.float32)
    feats = rng.randn(2, n, c).astype(np.float32)
    arg = {"fps": None, "prefix": "prefix",
           "given": rng.randint(0, n, (2, psa.npoint)).astype(np.int32)}[inds]
    want = jsa(jnp.asarray(xyz), jnp.asarray(feats),
               arg if not isinstance(arg, np.ndarray) else jnp.asarray(arg), train=False)
    with torch.inference_mode():
        got = psa(_t(xyz), _t(feats), arg if not isinstance(arg, np.ndarray) else _t(arg))
    _equal(got[0], want[0])  # centers
    _equal(got[2], want[2])  # indices
    _close(got[1], want[1])


def test_fp_module_matches_flax(pair):
    bound, pm, *_ = pair
    rng = np.random.RandomState(4)
    unknown, known = rng.uniform(-3, 3, (2, 32, 3)), rng.uniform(-3, 3, (2, 16, 3))
    uf, kf = rng.randn(2, 32, 256), rng.randn(2, 16, 256)
    args = [a.astype(np.float32) for a in (unknown, known, uf, kf)]
    want = bound.backbone_net.fp1(*map(jnp.asarray, args), train=False)
    with torch.inference_mode():
        got = pm.backbone_net.fp1(*map(_t, args))
    _close(got, want)


def test_voting_module_matches_flax(pair):
    bound, pm, *_ = pair
    rng = np.random.RandomState(5)
    xyz = rng.uniform(-3, 3, (2, 64, 3)).astype(np.float32)
    feats = rng.randn(2, 64, 256).astype(np.float32)
    want = bound.vgen(jnp.asarray(xyz), jnp.asarray(feats), train=False)
    with torch.inference_mode():
        got = pm.vgen(_t(xyz), _t(feats))
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_proposal_module_matches_flax(pair):
    bound, pm, *_ = pair
    rng = np.random.RandomState(6)
    votes = rng.uniform(-3, 3, (2, 64, 3)).astype(np.float32)
    feats = rng.randn(2, 64, 256).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    want = bound.pnet(jnp.asarray(votes), jnp.asarray(feats), {"seed_xyz": jnp.asarray(votes)},
                      train=False)
    with torch.inference_mode():
        got = pm.pnet(_t(votes), _t(feats), {"seed_xyz": _t(votes)})
    _equal(got["aggregated_vote_inds"], want["aggregated_vote_inds"])
    for k in ("aggregated_vote_xyz", "objectness_scores", "center", "heading_scores",
              "heading_residuals", "size_scores", "size_residuals", "sem_cls_scores"):
        _close(got[k], want[k])


def test_grid_conv_matches_flax(pair):
    """Random headings exercise the rotation (ScanNet's are always 0)."""
    bound, pm, *_ = pair
    rng = np.random.RandomState(7)
    center = rng.uniform(-2, 2, (2, 16, 3)).astype(np.float32)
    size = rng.uniform(0.1, 1.0, (2, 16, 3)).astype(np.float32)
    heading = rng.uniform(-np.pi, np.pi, (2, 16)).astype(np.float32)
    seed_xyz = rng.uniform(-3, 3, (2, 64, 3)).astype(np.float32)
    seed_feats = rng.randn(2, 64, 256).astype(np.float32)
    want = bound.grid_conv(jnp.asarray(center), jnp.asarray(size), jnp.asarray(heading),
                           {"seed_xyz": jnp.asarray(seed_xyz),
                            "seed_features": jnp.asarray(seed_feats)}, train=False)
    with torch.inference_mode():
        got = pm.grid_conv(_t(center), _t(size), _t(heading),
                           {"seed_xyz": _t(seed_xyz), "seed_features": _t(seed_feats)})
    _close(got["iou_scores"], want["iou_scores"])


@pytest.fixture(scope="module")
def full_outputs(pair):
    _, pm, variables, jm, _ = pair
    pc = scenes(21)
    want = jax.tree.map(np.asarray, jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, jnp.asarray(pc)))
    with torch.inference_mode():
        got = pm(_t(pc))
    return got, want


def test_votenet_forward_matches_flax(full_outputs):
    got, want = full_outputs
    for k in ("sa1_inds", "seed_inds", "aggregated_vote_inds"):
        _equal(got[k], want[k])
    for k in KEEP:
        _close(got[k], want[k])


def test_votenet_forward_with_injected_sa1_inds_matches_flax(pair):
    """Given SA1 indices replace the FPS; the seeds are their prefix."""
    _, pm, variables, jm, _ = pair
    pc = scenes(31)
    inds = np.random.RandomState(31).randint(0, 2048, (2, 128)).astype(np.int32)
    want = jm.apply(variables, jnp.asarray(pc), train=False, sa1_inds=jnp.asarray(inds))
    with torch.inference_mode():
        got = pm(_t(pc), sa1_inds=_t(inds))
    _equal(got["sa1_inds"], inds)
    _equal(got["seed_inds"], want["seed_inds"])
    for k in ("center", "objectness_scores", "iou_scores"):
        _close(got[k], want[k])


def test_eval_forward_and_parse_predictions_match_jax(pair, full_outputs):
    """make_eval_forward returns the JAX eval forward's keep set, and the
    port's parse_predictions picks the same boxes as the JAX package's."""
    from iou3dmatch_tpu.eval.ap_helper import parse_predictions as jax_parse

    from iou3dmatch_tpu_torch.eval.ap_helper import eval_config_dict, parse_predictions

    _, pm, _, _, cfg = pair
    _, want = full_outputs
    out = make_eval_forward(pm)(_t(scenes(21)))
    assert set(out) == set(KEEP)
    assert not pm.training
    config = eval_config_dict(cfg, use_iou_for_nms=True)
    got_picks = parse_predictions(out, config)
    want_picks = jax_parse({k: want[k] for k in KEEP}, config)
    assert [len(p) for p in got_picks] == [len(p) for p in want_picks]
    for gs, ws in zip(got_picks, want_picks):
        for (gc, gbox, gscore), (wc, wbox, wscore) in zip(gs, ws):
            assert gc == wc
            np.testing.assert_allclose(gbox, wbox, rtol=0, atol=ATOL)
            np.testing.assert_allclose(gscore, wscore, rtol=0, atol=ATOL)
