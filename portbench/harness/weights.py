"""The model's weights, drawn on the card from ``--seed`` in two calls.

Both the program and the reference take the same state dict: every
parameter by name, in name order, from one standard-normal and one uniform
draw of a ``torch.Generator`` on the device. Each leaf is drawn as the
port's and the reference's initialisers draw it
(``pointnet2/pytorch_utils.py``, ``models/mlp.py``): a shared MLP's 1x1
convolution, (out, in, 1, 1), kaiming-normal; a head's convolution, (out,
in, 1), and its bias uniform in +-1/sqrt(in); a BatchNorm's weight 1 and
bias 0. The BatchNorm running statistics are left as the model makes
them (mean 0, variance 1).
"""
import torch


def kinds(shapes: dict) -> dict:
    """name -> ("normal", std) | ("uniform", bound) | ("const", value)."""
    out = {}
    for name, shape in shapes.items():
        stem = name.rsplit(".", 1)[0]
        weight = shapes.get(stem + ".weight")
        if len(shape) == 4:
            out[name] = ("normal", (2.0 / shape[1]) ** 0.5)
        elif len(shape) == 3:
            out[name] = ("uniform", shape[1] ** -0.5)
        elif name.endswith(".bias") and weight is not None and len(weight) == 3:
            out[name] = ("uniform", weight[1] ** -0.5)
        elif name.endswith(".weight") and len(shape) == 1:
            out[name] = ("const", 1.0)
        elif name.endswith(".bias") and len(shape) == 1:
            out[name] = ("const", 0.0)
        else:
            raise ValueError(f"no initialiser for parameter {name} {tuple(shape)}")
    return out


def make(shapes: dict, seed: int, device) -> dict:
    """{name: tensor} for ``shapes`` ({name: shape}), f32 on ``device``."""
    kind = kinds(shapes)
    names = sorted(shapes)
    numel = {n: int(torch.Size(shapes[n]).numel()) for n in names}
    gen = torch.Generator(device=device).manual_seed(seed)
    n_normal = sum(numel[n] for n in names if kind[n][0] == "normal")
    n_uniform = sum(numel[n] for n in names if kind[n][0] == "uniform")
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, {"normal": 0, "uniform": 0}
    for n in names:
        k, v = kind[n]
        if k == "const":
            out[n] = torch.full(shapes[n], v, device=device)
            continue
        src = normal if k == "normal" else uniform
        out[n] = src[at[k]:at[k] + numel[n]].view(shapes[n]) * v
        at[k] += numel[n]
    return out


def shapes_of(model) -> dict:
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def load(model, weights: dict) -> None:
    """Copies ``weights`` into ``model``'s parameters; the names must be the
    same set."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise KeyError(f"parameters differ: {sorted(set(params) ^ set(weights))[:6]}")
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(weights[n])
