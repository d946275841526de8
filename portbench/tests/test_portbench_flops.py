"""The model-FLOP count from shapes against a count by forward hooks on the
reference model's layers, and the kernel bounds against ``chip_smoke.py``'s
numbers for the same shapes."""
import pytest
import torch

from harness import manifest, shapes
from plainref.models.factory import build_votenet
from plainref.models.mlp import PointwiseConv, set_bn_momentum

TINY = dict(num_point=1024, num_proposal=16, sa_npoints=[128, 64, 32, 16])


def hooked_macs(model, call) -> int:
    total = []

    def hook(mod, inputs, out):
        x = inputs[0]
        w = mod.weight.flatten(1)
        total.append(x.numel() // x.shape[-1] * w.shape[0] * w.shape[1])

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, PointwiseConv)]
    try:
        call()
    finally:
        for h in handles:
            h.remove()
    return sum(total)


@pytest.mark.parametrize("name", ["scannet-votenet-iou", "sunrgbd-votenet-iou"])
@pytest.mark.parametrize("jitter", [False, True])
def test_flops_from_shapes_equal_the_hooked_count(name, jitter):
    bench = manifest.load()
    c = dict(manifest.config(bench, name), **TINY)
    model, _ = build_votenet(c["dataset"], num_proposal=c["num_proposal"],
                             input_feature_dim=c["input_feature_dim"], tiny=True, device="cpu")
    b = 2
    pc = torch.rand(b, c["num_point"], 3 + c["input_feature_dim"]) * 4.0
    if jitter:
        model.train()
        set_bn_momentum(model, 0.5)
        call = lambda: model.forward_with_pred_jitter(pc, generator=torch.Generator().manual_seed(0))  # noqa: E731
    else:
        call = lambda: model(pc)  # noqa: E731
    with torch.no_grad():
        macs = hooked_macs(model, call)
    k = c["num_proposal"] * (2 if jitter else 1)
    assert shapes.flops(shapes.linears(c, b, k)) == 2 * macs


def test_step_flops_follow_the_rules():
    bench = manifest.load()
    c = manifest.config(bench, "scannet-votenet-iou")
    fwd = lambda b, k: shapes.flops(shapes.linears(c, b, k))  # noqa: E731
    grid = shapes.flops(shapes.linears(c, 8, 128), "iou.")
    assert shapes.model_flops(c, manifest.mix("scannet-ssl")) == 4 * fwd(12, 256)
    assert shapes.model_flops(c, manifest.mix("sunrgbd-pretrain")) == 3 * fwd(8, 256)
    assert shapes.model_flops(c, manifest.mix("sunrgbd-eval")) == fwd(8, 128)
    assert shapes.model_flops(c, manifest.mix("scannet-eval-opt")) == fwd(8, 128) + 23 * grid


# chip_smoke.py's bounds (PERF.md's kernel table, my chip runs of PRs 8-18,
# clocks.max.sm 1980 MHz, 132 SMs): (kernel, shape, bound ms) where the
# harness counts the same bytes and operations
PEAK = {"hbm_bytes_per_s": 3.35e12, "issue_ops_per_s": 132 * 128 * 1980e6}
SAME = [
    ("fps", dict(b=8, n=40000, npoint=2048), 0.176),
    ("fps", dict(b=24, n=40000, npoint=2048), 0.529),
    ("ball_query", dict(b=8, n=40000, m=2048, ns=64), 0.00246),
    ("gather_bwd", dict(b=8, n=2048, c=131, q=1024 * 32), 0.0439),
    ("gather_bwd", dict(b=12, n=2048, c=131, q=1024 * 32), 0.0658),
    ("three_nn", dict(b=8, n=8192, m=1024), 0.0181),
    ("three_nn", dict(b=12, n=16384, m=1024), 0.0543),
    ("three_interpolate_bwd", dict(b=8, n=512, m=256, c=256), 0.00191),
    ("three_interpolate_bwd", dict(b=8, n=1024, m=512, c=256), 0.00381),
]
# where chip_smoke.py also counts the table rows the indices name (data):
# the harness's bound is its bound less those rows' bytes
LESS_ROWS = [
    ("gather", dict(b=8, n=2048, c=131, q=1024 * 32), 0.0439),
    ("three_interpolate", dict(b=8, n=1024, m=512, c=256, skip=256), 0.00882),
]


@pytest.mark.parametrize("kernel, shape, ms", SAME)
def test_kernel_bounds_equal_chip_smoke(kernel, shape, ms):
    got = manifest.module("kernels", kernel).bound_s(shape, PEAK) * 1e3
    assert got == pytest.approx(ms, rel=5e-3)


@pytest.mark.parametrize("kernel, shape, ms", LESS_ROWS)
def test_kernel_bounds_leave_out_only_the_rows_read(kernel, shape, ms):
    got = manifest.module("kernels", kernel).bound_s(shape, PEAK) * 1e3
    rows = shape["b"] * min(shape.get("m", shape["n"]), shape["n"]) * shape["c"] * 4
    assert got < ms
    assert got + rows / PEAK["hbm_bytes_per_s"] * 1e3 == pytest.approx(ms, rel=0.02)


def test_every_kernel_file_names_its_kernel():
    for name, mod in manifest.kernel_modules().items():
        assert mod.PATTERN and (mod.bound_s is None or callable(mod.bound_s)), name
