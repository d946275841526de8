"""The port's three-nearest-neighbour search against the JAX package.

``three_nn_plain`` (the plain PyTorch version that ``csrc/three_nn.cu`` is
held to on the card) against JAX's ``three_nn(exact=True)`` on every case of
``tests/three_nn_cases.py``: indices equal, distances within atol 1e-6,
rtol 0 (the two sum d2 in their own orders; NaN and inf where the other
has them). Then the wrapper's CPU route, and GridConv and an FP module on
inputs with ties against their flax counterparts, with the weights carried
across by ``train/torch_import.py`` (``tests/test_torch_models.py``'s tiny
model, atol 1e-4 as there).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from iou3dmatch_tpu_torch.ops import _build  # noqa: E402
from iou3dmatch_tpu_torch.ops.interpolate import three_nn, three_nn_plain  # noqa: E402
from tests.test_torch_models import pair  # noqa: E402,F401  (the tiny model pair fixture)
from tests.three_nn_cases import CASES, grids  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_nn_plain_matches_jax(case):
    from iou3dmatch_tpu.ops.interpolate import three_nn as jax_three_nn

    unknown, known = CASES[case]()
    jd, ji = jax_three_nn(jnp.asarray(unknown), jnp.asarray(known), True)
    d, i = three_nn_plain(torch.from_numpy(unknown), torch.from_numpy(known))
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    assert d.shape == i.shape == unknown.shape
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    assert int(i.min()) >= 0 and int(i.max()) < known.shape[1]


def test_three_nn_takes_the_plain_version_on_the_cpu_without_counting():
    unknown, known = (torch.from_numpy(x) for x in CASES["grid_duplicate_seeds_m1024"]())
    before = three_nn.launches
    d, i = three_nn(unknown, known)
    assert three_nn.launches == before
    want_d, want_i = three_nn_plain(unknown, known)
    assert torch.equal(i, want_i)
    assert torch.equal(d, want_d)


def test_three_nn_outputs_carry_no_gradient():
    unknown, known = (torch.from_numpy(x).requires_grad_() for x in CASES["m3"]())
    d, i = three_nn(unknown, known)
    assert not d.requires_grad and not i.requires_grad


def test_three_nn_refuses_misshapen_input():
    unknown, known = (torch.from_numpy(x) for x in CASES["m3"]())
    for u, k in ((unknown[..., :2], known), (unknown, known[..., :2]), (unknown[0], known[0]),
                 (unknown, known[:1]), (unknown, known[:, :0])):
        with pytest.raises(ValueError):
            three_nn(u, k)


def test_three_nn_builds_without_multiply_add_contraction():
    """csrc/three_nn.cu rounds each difference, product and sum on its own,
    as its plain version does."""
    assert "three_nn" in _build.SOURCES
    assert "-fmad=false" in _build._flags("three_nn")
    assert "--use_fast_math" not in _build._flags("three_nn")


def test_grid_conv_on_duplicate_seeds_matches_flax(pair):  # noqa: F811
    """Boxes centred near seeds, a quarter of which are exact copies of
    others: the grid's neighbours tie, and the lower index must win on
    both sides for the IoU logits to agree."""
    bound, pm, *_ = pair
    _, known = grids(9, 2, 16, 64, duplicates=True)
    rng = np.random.RandomState(10)
    center = (known[:, :16] + rng.normal(0, 0.1, (2, 16, 3))).astype(np.float32)
    size = rng.uniform(0.1, 1.0, (2, 16, 3)).astype(np.float32)
    heading = rng.uniform(-np.pi, np.pi, (2, 16)).astype(np.float32)
    feats = rng.randn(2, 64, 256).astype(np.float32)
    want = bound.grid_conv(jnp.asarray(center), jnp.asarray(size), jnp.asarray(heading),
                           {"seed_xyz": jnp.asarray(known), "seed_features": jnp.asarray(feats)},
                           train=False)
    with torch.inference_mode():
        got = pm.grid_conv(*(torch.from_numpy(x) for x in (center, size, heading)),
                           {"seed_xyz": torch.from_numpy(known),
                            "seed_features": torch.from_numpy(feats)})
    np.testing.assert_allclose(got["iou_scores"].numpy(), np.asarray(want["iou_scores"]),
                               rtol=0, atol=1e-4)


def test_fp_module_on_ties_and_a_ragged_count_matches_flax(pair):  # noqa: F811
    """FP2 with 37 queries (not a multiple of a block) against 16 known
    points on a lattice, some queries at equal distance from several."""
    bound, pm, *_ = pair
    rng = np.random.RandomState(11)
    known = np.stack(np.meshgrid([0.0, 1.0], [0.0, 1.0], [0.0, 1.0, 2.0, 3.0], indexing="ij"),
                     -1).reshape(1, 16, 3).repeat(2, 0)
    unknown = rng.randint(0, 7, (2, 37, 3)) * 0.5
    args = [a.astype(np.float32) for a in (unknown, known, rng.randn(2, 37, 256),
                                            rng.randn(2, 16, 256))]
    want = bound.backbone_net.fp2(*map(jnp.asarray, args), train=False)
    with torch.inference_mode():
        got = pm.backbone_net.fp2(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
