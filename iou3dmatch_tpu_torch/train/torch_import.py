"""Weights from the JAX package into the port.

``state_dict_from_jax`` turns the JAX package's ``{"params", "batch_stats"}``
tree (nested dicts of NumPy arrays) into the port's state dict, whose keys
are the reference 3DIoUMatch ones. It carries its own copy of the JAX
package's key rule (``iou3dmatch_tpu/train/torch_import.py:31-63``) and of
its kernel transposes (``:160-201``), so the port never imports the JAX
package.
"""
import re

import numpy as np
import torch

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}


def flax_path_to_torch_key(path_names) -> str:
    """``params/backbone_net/sa1/mlp/dense0/kernel`` ->
    ``backbone_net.sa1.mlp_module.layer0.conv.weight``;
    ``batch_stats/vgen/bn1/mean`` -> ``vgen.bn1.running_mean``.

    A SharedMLP is ``mlp_module`` in SA and vote-aggregation modules and
    keeps its own name in FP (``mlp``) and GridConv (``mlp_before_iou``)."""
    _, *mods, leaf = path_names
    if leaf not in _LEAF:
        raise KeyError(f"no destination for leaf {'/'.join(path_names)}")
    out = []
    shared_mlp = False
    for i, m in enumerate(mods):
        if m.startswith("mlp"):
            parent = mods[i - 1] if i else ""
            out.append("mlp_module" if (m == "mlp" and not parent.startswith("fp")) else m)
            shared_mlp = True
        elif shared_mlp and re.fullmatch(r"dense\d+", m):
            out.append(f"layer{m[5:]}.conv")
        elif shared_mlp and re.fullmatch(r"bn\d+", m):
            out.append(f"layer{m[2:]}.bn.bn")
        else:
            out.append(m)
    out.append(_LEAF[leaf])
    return ".".join(out)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if hasattr(v, "items"):  # a dict or a flax FrozenDict
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def state_dict_from_jax(variables) -> dict:
    """``{"params", "batch_stats"}`` nested dicts of arrays -> the port's
    state dict of float32 tensors. Either collection may be absent: a JAX
    gradient tree passed as ``{"params": grads}`` gives the gradients under
    the port's parameter names.

    Dense kernels (in, out) become convolution weights: (out, in, 1, 1)
    inside a SharedMLP, (out, in, 1) in the heads. Strict: raises on a leaf
    the key rule cannot place (including a SharedMLP dense bias, which the
    bias-free reference convs have no slot for) or of the wrong rank."""
    out = {}
    for names, leaf in _leaves({k: variables[k] for k in ("params", "batch_stats")
                                if k in variables}):
        names = [str(n) for n in names]
        key = flax_path_to_torch_key(names)
        val = np.asarray(leaf, dtype=np.float32)
        in_shared_mlp = any(m.startswith("mlp") for m in names[1:-1])
        if names[-1] == "kernel":
            if val.ndim != 2:
                raise ValueError(f"{key}: Dense kernel must be 2-D, got {val.shape}")
            val = val.T.reshape(val.shape[::-1] + ((1, 1) if in_shared_mlp else (1,)))
        else:
            if val.ndim != 1:
                raise ValueError(f"{key}: expected a 1-D leaf, got {val.shape}")
            if names[-1] == "bias" and in_shared_mlp and re.fullmatch(r"dense\d+", names[-2]):
                raise KeyError(f"no destination for SharedMLP bias {'/'.join(names)}")
        if key in out:
            raise KeyError(f"two leaves map to {key}")
        out[key] = torch.from_numpy(np.array(val))  # a writable copy
    return out
