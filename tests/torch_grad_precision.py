"""Float32 precision of the pretrain gradient, on the CPU: prints the numbers
that tests/test_torch_train.py and ROADMAP.md (Queue 3) cite.

1. PyTorch's CPU ``F.batch_norm`` in training mode against the two-pass
   statistics written out in float32, each against float64, on channels
   whose mean dwarfs their spread.
2. On ``scenes`` batches of test_torch_train's tiny recipe: the step-0
   gradient of the detection terms of the labeled loss (vote, objectness,
   box, semantic class: every term but the IoU ones, whose labels are
   detached on purpose) for the port in float32 and float64 and for the
   JAX package in float32, their cosines, and one directional derivative
   of each against central differences of the port in float64.

Run from the repository root: ``python tests/torch_grad_precision.py
[scenes]`` (6 by default; about a minute).
"""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import test_torch_train as T  # noqa: E402
from iou3dmatch_tpu_torch.models.mlp import set_bn_momentum  # noqa: E402

SA4 = "backbone_net.sa4.mlp_module.layer1.conv.weight"


def batch_norm_precision():
    gen = torch.Generator().manual_seed(0)
    n, c = 262_144, 16  # SA1's rows of 2 scenes; spreads 1e-3 to 1, means 0 to 20
    x = torch.randn(n, c, generator=gen) * torch.logspace(-3, 0, c) + torch.linspace(0, 20, c)
    x64 = x.double()
    want = (x64 - x64.mean(0)) / torch.sqrt(x64.var(0, unbiased=False) + 1e-5)
    native = F.batch_norm(x, None, None, None, None, True, 0.1, 1e-5)
    centered = x - x.mean(0)
    written = centered * torch.rsqrt((centered * centered).mean(0) + 1e-5)
    for name, got in (("F.batch_norm", native), ("two-pass", written)):
        print(f"{name}: max |out - f64| {float((got.double() - want).abs().max()):.2e}")


def detection(m):
    return m["vote_loss"] + 0.5 * m["objectness_loss"] + m["box_loss"] + 0.1 * m["sem_cls_loss"]


def gradients(b):
    setup = T.setup._fixture_function()
    key = jax.random.fold_in(jax.random.PRNGKey(42), 0)
    pc = T.scenes(100, b)
    anchors = setup.forward(setup.variables, jnp.asarray(pc), key)[0]["aggregated_vote_xyz"]
    batch = T.labels_near(200, np.asarray(anchors), setup.cfg)
    batch["point_clouds"] = pc
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    noise = T.jitter_noise(key, b, 16)

    def jax_loss(p):
        from iou3dmatch_tpu.losses import get_labeled_loss

        ep = setup.jm.apply({"params": p, "batch_stats": setup.variables["batch_stats"]},
                            jb["point_clouds"], key, train=True, momentum=T.MOMENTUM,
                            mutable=["batch_stats"], method=setup.jm.forward_with_pred_jitter)[0]
        return detection(get_labeled_loss(ep, jb, setup.cfg, b)[1])

    jax32 = T.state_dict_from_jax({"params": T._np_tree(
        jax.jit(jax.grad(jax_loss))(setup.variables["params"]))})

    def port(dtype):
        pm = T.port_model(setup).to(dtype)
        set_bn_momentum(pm, T.MOMENTUM)
        tb = {k: (v.to(dtype) if v.is_floating_point() else v)
              for k, v in T.torch_batch(batch).items()}
        nz = tuple(T._t(x).to(dtype) for x in noise)

        def loss():
            ep = pm.forward_with_pred_jitter(tb["point_clouds"], noise=nz)
            return detection(T.plabeled.get_labeled_loss(ep, tb, setup.pcfg, b)[1])

        loss().backward()
        return pm, loss, {k: p.grad.double() for k, p in pm.named_parameters()
                          if p.grad is not None}

    _, _, p32 = port(torch.float32)
    pm64, loss64, p64 = port(torch.float64)

    def cos(a, c):
        x, y = T._flat(a, c)
        return round(float(x @ y / np.linalg.norm(x) / np.linalg.norm(y)), 6)

    print(f"{b} scenes: gradient cosine port f32 / port f64 {cos(p32, p64)}, "
          f"JAX f32 / port f64 {cos(jax32, p64)}, JAX f32 / port f32 {cos(jax32, p32)}")
    d = torch.randn(p64[SA4].shape, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    param = dict(pm64.named_parameters())[SA4]
    state = {k: v.clone() for k, v in pm64.state_dict().items()}
    vals = []
    for sign in (1.0, -1.0):
        pm64.load_state_dict(state)
        with torch.no_grad():
            param.add_(sign * 1e-7 * d)
            vals.append(float(loss64()))
    print(f"d loss along a random direction of {SA4}: central difference (f64) "
          f"{(vals[0] - vals[1]) / 2e-7:.6f}, port f64 {float((p64[SA4] * d).sum()):.6f}, "
          f"port f32 {float((p32[SA4] * d).sum()):.6f}, JAX f32 {float((jax32[SA4] * d).sum()):.6f}")


if __name__ == "__main__":
    torch.set_num_threads(1)
    batch_norm_precision()
    gradients(int(sys.argv[1]) if len(sys.argv) > 1 else 6)
