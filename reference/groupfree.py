"""A plain PyTorch reference of Group-Free-3D with the GridConv IoU branch.

Written from the published description: Liu, Zhang, Cao, Hu and Tong,
"Group-Free 3D Object Detection via Transformers", ICCV 2021,
arXiv:2104.00678, and its code (github.com/zeliu98/Group-Free-3D:
``models/detector.py``, ``models/transformer.py``, ``models/modules.py``,
``models/backbone_module.py``, ``models/loss_helper.py``,
``train_dist.py``), with 3DIoUMatch's GridConv IoU branch and IoU losses
(github.com/yezhen17/3DIoUMatch, ``models/grid_conv_module.py``,
``models/loss_helper_labeled.py``). Float32 throughout, TF32 off, plain
``torch`` operations only: no hand kernel, and nothing imported from the
port or from JAX.

The model, for ScanNet (one heading bin, axis-aligned boxes):

- PointNet++ backbone at ``width`` times VoteNet's widths: SA layers of
  2,048 / 1,024 / 512 / 256 centers (radii 0.2 / 0.4 / 0.8 / 1.2, 64 / 32
  / 16 / 16 neighbours, grouped xyz divided by the radius, max pool), FP
  layers back to the 1,024 seeds with 288-d features;
- KPS: a three-conv objectness head on the seeds, the top ``num_proposal``
  by sigmoid (descending) as the queries;
- a prediction head on the queries, then ``num_decoder_layers`` post-norm
  decoder layers (d 288, 8 heads, FFN 2,048, ReLU, dropout 0.1), each with
  a learned position embedding of the previous stage's detached (center,
  size) for its queries and of the seeds' xyz for the cross-attention's
  key, added to the cross-attention's query, key and value, and a head of
  its own; a stage's center is the query's point plus its residual;
- GridConv on the last stage's boxes (half sizes) and, in training, on
  their jittered copies.

The loss: the release's ``get_loss`` with ``train_dist.py``'s ScanNet
weights (KPS top 4 with a sigmoid focal loss, 0.8; a focal objectness loss
on the query points, 0.1; center smooth-L1 delta 0.04; size residual
smooth-L1 delta 0.111; heading and size CE; semantic CE, 0.1; averaged
over the 1 + ``num_decoder_layers`` stages; all x 10), plus 10 x the IoU
branch's loss and its jittered boxes' loss (3DIoUMatch's).

Departures from the release, each also the port's:

- the dropout masks and the box jitter are drawn from an explicit
  ``torch.Generator``, in a fixed order (``DecoderLayer.forward``, then
  the jitter's two normal draws), so that a run can be replayed; the
  release draws from the global generator;
- SA2, SA3, SA4 take their inputs' first points as centers: their inputs
  come out of FPS in FPS order, so FPS would pick exactly those;
- a seed's object is the GT box whose center its vote label points at
  (the seed plus its first vote, the nearest GT center); the release
  reads the dataset's instance labels, whose boxes those votes point at;
- the IoU labels of these axis-aligned boxes are the closed-form IoU;
  3DIoUMatch computes them with OpenPCDet's rotated-IoU kernel, whose
  1e-2 containment margin can count a corner just outside a box as
  inside;
- BatchNorm takes two-pass statistics (the mean, then the variance of
  the centred rows), which PyTorch's CPU kernel does not.

``pretrain_step`` is one training step: the jittered forward in train
mode, the loss, the backward and AdamW (the parameters whose name holds
"decoder" at a tenth of the lr, as ``train_dist.py`` groups them).
"""
import math
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

D = 288
GRID = 4  # GridConv's lattice a side


# ---------------------------------------------------------------- point ops

def fps(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) -> (B, npoint) long: from point 0, each step the point
    farthest from those chosen (lowest index on ties); points with
    |p|^2 <= 1e-3 are never chosen (PointNet++'s sampling kernel)."""
    b, n, _ = xyz.shape
    small = (xyz * xyz).sum(-1) <= 1e-3
    mind = torch.full((b, n), 1e10, device=xyz.device).masked_fill(small, -1.0)
    out = torch.zeros((b, npoint), dtype=torch.long, device=xyz.device)
    rows = torch.arange(b, device=xyz.device)
    last = out[:, 0]
    for j in range(1, npoint):
        diff = xyz - xyz[rows, last][:, None]
        mind = torch.minimum(mind, (diff * diff).sum(-1))
        last = mind.argmax(1)
        out[:, j] = last
    return out


def rows_of(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (B, N, C), idx (B, ...) -> (B, ..., C)."""
    b = table.shape[0]
    batch = torch.arange(b, device=table.device).reshape((b,) + (1,) * (idx.dim() - 1))
    return table[batch, idx.long()]


def ball_query(radius: float, nsample: int, xyz: torch.Tensor, centers: torch.Tensor):
    """(B, m, nsample): the first ``nsample`` points, in index order, with
    squared distance below radius^2 (as float32); missing slots repeat the
    first (0 when there is none). A scene at a time."""
    r2 = float(np.float32(radius) * np.float32(radius))
    n = xyz.shape[1]
    order = torch.arange(n, device=xyz.device)
    out = []
    for p, c in zip(xyz, centers):
        d = c[:, None, :] - p[None, :, :]
        hit = (d * d).sum(-1) < r2
        first = torch.where(hit, order, n).topk(min(nsample, n), dim=1, largest=False).values
        if first.shape[1] < nsample:
            first = torch.cat([first, first.new_full((first.shape[0], nsample - n), n)], 1)
        found = first < n
        out.append(torch.where(found, first, torch.where(found[:, :1], first[:, :1], 0)))
    return torch.stack(out)


def three_nearest(unknown: torch.Tensor, known: torch.Tensor) -> torch.Tensor:
    """(B, n, 3) indices of the three nearest known points (lowest index
    on ties), by squared distance."""
    d = unknown[:, :, None, :] - known[:, None, :, :]
    d2 = (d * d).sum(-1)
    picks = []
    for _ in range(3):
        i = d2.argmin(2)
        picks.append(i)
        d2 = d2.scatter(2, i[..., None], float("inf"))
    return torch.stack(picks, -1)


def interpolate(at: torch.Tensor, known: torch.Tensor, features: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
    """Inverse-distance weights (1 / (d + 1e-8), normalised) of the three
    known points ``idx`` at ``at``, applied to their features; the
    gradient reaches ``at`` through the distances."""
    d = rows_of(known, idx) - at[:, :, None, :]
    w = 1.0 / (torch.sqrt((d * d).sum(-1)) + 1e-8)
    w = w / w.sum(-1, keepdim=True)
    return (rows_of(features, idx) * w[..., None]).sum(2)


# ---------------------------------------------------------------- layers

class Conv(nn.Module):
    """A 1x1 convolution over the last axis; ``weight`` (out, in, 1) with a
    bias, or (out, in, 1, 1) without one (a shared MLP's)."""

    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        shape = (cout, cin, 1) if bias else (cout, cin, 1, 1)
        self.weight = nn.Parameter(torch.randn(shape) * (1.0 / cin) ** 0.5)
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        return F.linear(x, self.weight.reshape(self.weight.shape[0], -1), self.bias)


class BN(nn.Module):
    """Batch norm over every leading axis, eps 1e-5: train mode normalises
    by the batch's mean and biased variance and moves the running
    statistics by ``momentum`` (the variance unbiased)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight, self.bias = nn.Parameter(torch.ones(c)), nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.momentum = 0.1

    def forward(self, x):
        if not self.training:
            return (x - self.running_mean) / torch.sqrt(self.running_var + 1e-5) * self.weight \
                + self.bias
        flat = x.reshape(-1, x.shape[-1])
        mean = flat.mean(0)
        var = ((flat - mean) ** 2).mean(0)
        with torch.no_grad():
            n, m = flat.shape[0], self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean)
            self.running_var.mul_(1 - m).add_(m * var * n / max(n - 1, 1))
        return (x - mean) / torch.sqrt(var + 1e-5) * self.weight + self.bias


class ConvBNReLU(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv(cin, cout, bias=False)
        self.bn = nn.ModuleDict({"bn": BN(cout)})

    def forward(self, x):
        return F.relu(self.bn["bn"](self.conv(x)))


def shared_mlp(channels) -> nn.Sequential:
    return nn.Sequential(OrderedDict((f"layer{i}", ConvBNReLU(a, b))
                                     for i, (a, b) in enumerate(zip(channels[:-1], channels[1:]))))


class SA(nn.Module):
    def __init__(self, mlp, npoint: int, radius: float, nsample: int):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.mlp_module = shared_mlp([mlp[0] + 3] + list(mlp[1:]))

    def forward(self, xyz, features, centers=None):
        """``centers`` (B, npoint) indices, else the first npoint points."""
        new_xyz = xyz[:, :self.npoint] if centers is None else rows_of(xyz, centers)
        idx = ball_query(self.radius, self.nsample, xyz, new_xyz)
        grouped_xyz = (rows_of(xyz, idx) - new_xyz[:, :, None]) / self.radius
        h = torch.cat([grouped_xyz, rows_of(features, idx)], -1)
        return new_xyz, self.mlp_module(h).amax(2)


class FP(nn.Module):
    def __init__(self, mlp):
        super().__init__()
        self.mlp = shared_mlp(mlp)

    def forward(self, unknown, known, unknown_feats, known_feats):
        idx = three_nearest(unknown, known)
        return self.mlp(torch.cat([interpolate(unknown, known, known_feats, idx), unknown_feats],
                                  -1))


class Backbone(nn.Module):
    def __init__(self, width: int, npoints=(2048, 1024, 512, 256)):
        super().__init__()
        w = width
        mlps = ((1, 64 * w, 64 * w, 128 * w), (128 * w, 128 * w, 128 * w, 256 * w),
                (256 * w, 128 * w, 128 * w, 256 * w), (256 * w, 128 * w, 128 * w, 256 * w))
        for i, (mlp, npoint, radius, ns) in enumerate(
                zip(mlps, npoints, (0.2, 0.4, 0.8, 1.2), (64, 32, 16, 16)), start=1):
            self.add_module(f"sa{i}", SA(mlp, npoint, radius, ns))
        self.fp1 = FP((512 * w, 256 * w, 256 * w))
        self.fp2 = FP((512 * w, 256 * w, D))

    def forward(self, pc):
        xyz, feats = pc[..., :3], pc[..., 3:]
        inds = fps(xyz, self.sa1.npoint)
        xyz1, f1 = self.sa1(xyz, feats, inds)
        xyz2, f2 = self.sa2(xyz1, f1)
        xyz3, f3 = self.sa3(xyz2, f2)
        xyz4, f4 = self.sa4(xyz3, f3)
        f = self.fp1(xyz3, xyz4, f3, f4)
        f = self.fp2(xyz2, xyz3, f2, f)
        return inds[:, :xyz2.shape[1]], xyz2, f


def drop(x, p: float, gen):
    """Dropout with its keep mask from ``gen`` (U(0, 1) >= p), scaled by
    1 / (1 - p); ``gen`` None: none."""
    if gen is None:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= p
    return x * keep.to(x.dtype) * (1.0 / (1.0 - p))


class Proj(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(cout, cin) * (1.0 / cin) ** 0.5)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Attention(nn.Module):
    """``nn.MultiheadAttention``'s math (``F.multi_head_attention_forward``):
    the packed in-projection (one product where query, key and value are
    the same tensor, a second for key and value where those two are), q
    scaled by 1/sqrt(36), softmax(q k^T) v over 8 heads of 36, dropout on
    the weights, the out-projection."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.in_proj_weight = nn.Parameter(torch.randn(3 * D, D) * (1.0 / D) ** 0.5)
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * D))
        self.out_proj = Proj(D, D)

    def forward(self, q_in, kv_in, gen):
        w, b = self.in_proj_weight, self.in_proj_bias
        if q_in is kv_in:
            q, k, v = F.linear(q_in, w, b).chunk(3, -1)
        else:
            q = F.linear(q_in, w[:D], b[:D])
            k, v = F.linear(kv_in, w[D:], b[D:]).chunk(2, -1)
        q, k, v = (x.reshape(x.shape[0], x.shape[1], 8, D // 8).transpose(1, 2)
                   for x in (q, k, v))
        a = torch.softmax((q * math.sqrt(1.0 / (D // 8))) @ k.transpose(2, 3), -1)
        a = drop(a, self.p, gen)
        out = (a @ v).transpose(1, 2).reshape(q_in.shape)
        return self.out_proj(out)


class DecoderLayer(nn.Module):
    def __init__(self, p: float = 0.1):
        super().__init__()
        self.p = p
        self.self_attn, self.multihead_attn = Attention(p), Attention(p)
        self.linear1, self.linear2 = Proj(D, 2048), Proj(2048, D)
        self.norm1, self.norm2, self.norm3 = nn.LayerNorm(D), nn.LayerNorm(D), nn.LayerNorm(D)

    def forward(self, query, key, query_pos, key_pos, gen):
        """Dropout draws, in order: the self-attention's weights, after
        self-attention, the cross-attention's weights, after it, the FFN's
        hidden units, after the FFN."""
        q = query + query_pos
        query = self.norm1(query + drop(self.self_attn(q, q, gen), self.p, gen))
        k = key + key_pos
        query = self.norm2(query + drop(self.multihead_attn(query + query_pos, k, gen),
                                        self.p, gen))
        hidden = drop(F.relu(self.linear1(query)), self.p, gen)
        return self.norm3(query + drop(self.linear2(hidden), self.p, gen))


class PosEmbed(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.position_embedding_head = nn.Sequential(OrderedDict([
            ("0", Conv(cin, D)), ("1", BN(D)), ("2", nn.ReLU()), ("3", Conv(D, D))]))

    def forward(self, x):
        return self.position_embedding_head(x)


class ObjCls(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1, self.bn1, self.conv2, self.bn2 = Conv(D, D), BN(D), Conv(D, D), BN(D)
        self.conv3 = Conv(D, 1)

    def forward(self, f):
        return self.conv3(F.relu(self.bn2(self.conv2(F.relu(self.bn1(self.conv1(f)))))))[..., 0]


class Head(nn.Module):
    def __init__(self, nc: int, nh: int, ns: int):
        super().__init__()
        self.nh, self.ns = nh, ns
        self.conv1, self.bn1, self.conv2, self.bn2 = Conv(D, D), BN(D), Conv(D, D), BN(D)
        self.objectness_scores_head = Conv(D, 1)
        self.center_residual_head = Conv(D, 3)
        self.heading_class_head = Conv(D, nh)
        self.heading_residual_head = Conv(D, nh)
        self.size_class_head = Conv(D, ns)
        self.size_residual_head = Conv(D, ns * 3)
        self.sem_cls_scores_head = Conv(D, nc)

    def forward(self, f, base_xyz, mean_size, out: dict, prefix: str):
        net = F.relu(self.bn2(self.conv2(F.relu(self.bn1(self.conv1(f))))))
        b, k = f.shape[:2]
        srn = self.size_residual_head(net).reshape(b, k, self.ns, 3)
        hrn = self.heading_residual_head(net)
        heads = {
            "objectness_scores": self.objectness_scores_head(net),
            "center": base_xyz + self.center_residual_head(net),
            "heading_scores": self.heading_class_head(net),
            "heading_residuals_normalized": hrn,
            "heading_residuals": hrn * (np.pi / self.nh),
            "size_scores": self.size_class_head(net),
            "size_residuals_normalized": srn,
            "size_residuals": srn * mean_size,
            "sem_cls_scores": self.sem_cls_scores_head(net),
        }
        size = pick_cluster(heads["size_residuals"] + mean_size, heads["size_scores"].argmax(-1))
        for name, v in heads.items():
            out[prefix + name] = v
        return heads["center"], size


class GridConv(nn.Module):
    def __init__(self, nc: int, nh: int, ns: int):
        super().__init__()
        self.nc = nc
        self.mlp_before_iou = shared_mlp((3 + D, 128, 128, 128))
        self.conv1_iou, self.bn1_iou = Conv(128, 128), BN(128)
        self.conv2_iou, self.bn2_iou = Conv(128, 128), BN(128)
        self.conv3_iou = Conv(128, 3 + nh * 2 + ns * 3 + nc)
        step = torch.linspace(-1.0, 1.0, GRID)
        self.register_buffer("offsets", torch.stack(torch.meshgrid(step, step, step,
                                                                   indexing="ij"), -1)
                             .reshape(-1, 3), persistent=False)

    def forward(self, center, half_size, seed_xyz, seed_features):
        """The IoU logits (B, K, num_class) of axis-aligned boxes: a 4x4x4
        lattice over each box, seed features interpolated onto it from the
        three nearest seeds, [lattice offset | features] through the MLP,
        max over the lattice, the conv head's last num_class channels."""
        b, k = center.shape[:2]
        grid = self.offsets[None, None] * half_size[:, :, None] + center[:, :, None]
        rel = grid - center[:, :, None]  # (B, K, 64, 3)
        grid = grid.reshape(b, -1, 3)
        seeds, feats = seed_xyz.detach(), seed_features.detach()
        interp = interpolate(grid, seeds, feats, three_nearest(grid, seeds))
        h = torch.cat([rel.reshape(b, -1, 3), interp], -1).reshape(b, k, GRID ** 3, -1)
        net = self.mlp_before_iou(h).amax(2)
        net = F.relu(self.bn1_iou(self.conv1_iou(net)))
        net = F.relu(self.bn2_iou(self.conv2_iou(net)))
        return self.conv3_iou(net)[..., -self.nc:]


# ---------------------------------------------------------------- the model

class GroupFree(nn.Module):
    def __init__(self, mean_size_arr, num_class: int = 18, num_proposal: int = 256,
                 num_decoder_layers: int = 12, width: int = 2,
                 sa_npoints=(2048, 1024, 512, 256)):
        super().__init__()
        ns = len(mean_size_arr)
        self.k, self.layers = num_proposal, num_decoder_layers
        self.register_buffer("mean_size", torch.tensor(np.asarray(mean_size_arr),
                                                       dtype=torch.float32), persistent=False)
        self.backbone_net = Backbone(width, sa_npoints)
        self.points_obj_cls = ObjCls()
        self.proposal_head = Head(num_class, 1, ns)
        self.decoder_key_proj, self.decoder_query_proj = Conv(D, D), Conv(D, D)
        self.decoder_self_posembeds = nn.ModuleList(PosEmbed(6) for _ in range(num_decoder_layers))
        self.decoder_cross_posembeds = nn.ModuleList(
            PosEmbed(3) for _ in range(num_decoder_layers))
        self.decoder = nn.ModuleList(DecoderLayer() for _ in range(num_decoder_layers))
        self.prediction_heads = nn.ModuleList(Head(num_class, 1, ns)
                                              for _ in range(num_decoder_layers))
        self.grid_conv = GridConv(num_class, 1, ns)

    def prefixes(self) -> list:
        """The stages in the release's loss order."""
        if not self.layers:
            return ["proposal_"]
        return ["proposal_", "last_"] + [f"{i}head_" for i in range(self.layers - 1)]

    def detect(self, pc, gen=None) -> dict:
        """Every stage's heads, the KPS logits and the queries' seeds;
        ``gen`` (train mode) draws the dropout masks."""
        gen = gen if self.training else None
        out = {}
        seed_inds, seed_xyz, seed_f = self.backbone_net(pc)
        out.update(seed_inds=seed_inds, seed_xyz=seed_xyz, seed_features=seed_f)
        logits = self.points_obj_cls(seed_f)
        q_inds = torch.topk(torch.sigmoid(logits), self.k)[1]
        out.update(kps_logits=logits, query_inds=q_inds)
        q_xyz, q_f = rows_of(seed_xyz, q_inds), rows_of(seed_f, q_inds)
        center, size = self.proposal_head(q_f, q_xyz, self.mean_size, out, "proposal_")
        if self.layers:
            query, key = self.decoder_query_proj(q_f), self.decoder_key_proj(seed_f)
        for i in range(self.layers):
            prefix = "last_" if i == self.layers - 1 else f"{i}head_"
            pos = torch.cat([center, size], -1).detach()
            query = self.decoder[i](query, key, self.decoder_self_posembeds[i](pos),
                                    self.decoder_cross_posembeds[i](seed_xyz), gen)
            center, size = self.prediction_heads[i](query, q_xyz, self.mean_size, out, prefix)
        last = "last_" if self.layers else "proposal_"
        full = pick_cluster(self.mean_size + out[last + "size_residuals"],
                            out[last + "size_scores"].argmax(-1))
        out["half_size"] = torch.where(full / 2.0 < 0, 1e-6, full / 2.0)
        out["last"], out["stages"] = last, self.prefixes()
        return out

    def forward(self, pc, gen=None, jitter: bool = False) -> dict:
        """The detector and the IoU logits of the last stage's boxes; with
        ``jitter`` also of their jittered copies (center + half size x
        N(0, 1) x 0.3, half size x (1 + N(0, 1) x 0.3) clamped at 1e-8, the
        two normal draws from ``gen`` after the dropout masks)."""
        out = self.detect(pc, gen)
        center = out[out["last"] + "center"].detach()
        half = out["half_size"].detach()
        if jitter:
            n_c = torch.randn(half.shape, generator=gen, device=half.device)
            n_s = torch.randn(half.shape, generator=gen, device=half.device)
            jc = center + half * n_c * 0.3
            js = (half + half * n_s * 0.3).clamp(min=1e-8)
            both = self.grid_conv(torch.cat([center, jc], 1), torch.cat([half, js], 1),
                                  out["seed_xyz"], out["seed_features"])
            k = center.shape[1]
            out["iou_scores"], out["iou_scores_jitter"] = both[:, :k], both[:, k:]
            out["jitter_center"], out["jitter_size"] = jc, js * 2
        else:
            out["iou_scores"] = self.grid_conv(center, half, out["seed_xyz"], out["seed_features"])
        return out


# ---------------------------------------------------------------- the loss

def smoothl1(x, delta: float):
    a = x.abs()
    return torch.where(a < delta, 0.5 * a * a / delta, a - 0.5 * delta)


def focal(logits, target):
    """Sigmoid focal loss (gamma 2, alpha 0.25), each scene's weights
    1 / its points, summed and divided by the scenes."""
    t = target.float()
    p = torch.sigmoid(logits)
    w = (t * 0.25 + (1 - t) * 0.75) * (t * (1 - p) + (1 - t) * p) ** 2
    bce = torch.clamp(logits, min=0) - logits * t + torch.log1p(torch.exp(-logits.abs()))
    return (w * bce).sum() / logits.numel()


def pick(x, idx):
    """x (B, G, ...) at idx (B, K) -> (B, K, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def aabb_iou(a, b):
    """Axis-aligned 3D IoU of (B, K, 6) and (B, G, 6) boxes (center, full
    size) -> (B, K, G); the union clamped at 1e-6."""
    a, b = a[:, :, None], b[:, None]
    lo = torch.maximum(a[..., :3] - a[..., 3:] / 2, b[..., :3] - b[..., 3:] / 2)
    hi = torch.minimum(a[..., :3] + a[..., 3:] / 2, b[..., :3] + b[..., 3:] / 2)
    inter = (hi - lo).clamp(min=0).prod(-1)
    union = a[..., 3:].prod(-1) + b[..., 3:].prod(-1) - inter
    return inter / union.clamp(min=1e-6)


def iou_regression(scores, boxes, labels, mean_size):
    """The IoU branch's loss on (B, K, 6) boxes: each box's label is its
    largest IoU with a GT box of its scene (empty slots far away), its
    prediction the sigmoid of its logit at that GT box's class; a Huber
    loss (delta 1) averaged over every box."""
    gt_size = mean_size[labels["size_class_label"]] + labels["size_residual_label"]
    gt_center = torch.where(labels["box_label_mask"][..., None] > 0,
                            labels["center_label"], torch.full_like(labels["center_label"], -1000))
    with torch.no_grad():
        iou, which = aabb_iou(boxes, torch.cat([gt_center, gt_size], -1)).max(-1)
    cls = pick(labels["sem_cls_label"], which)
    pred = torch.sigmoid(scores).gather(2, cls[..., None])[..., 0]
    e = (pred - iou).abs()
    return torch.where(e <= 1.0, 0.5 * e * e, e - 0.5).mean()


def loss(out: dict, labels: dict, mean_size) -> torch.Tensor:
    """The training loss (the module docstring) of ``forward(...,
    jitter=True)``'s ``out`` on the GT ``labels``."""
    seed_inds = out["seed_inds"]
    b, s = seed_inds.shape
    g = labels["center_label"].shape[1]
    mask = labels["box_label_mask"]
    on_obj = labels["vote_label_mask"].gather(1, seed_inds)
    vote = pick(labels["vote_label"], seed_inds)[..., :3]
    gt_far = torch.where(mask[..., None] > 0, labels["center_label"],
                         torch.full_like(labels["center_label"], -1000))
    d = out["seed_xyz"][:, :, None] + vote[:, :, None] - gt_far[:, None]
    inst = torch.where(on_obj > 0, (d * d).sum(-1).argmin(-1), -1)  # (B, S)
    assign = torch.where(inst < 0, g - 1, inst)

    # KPS: the 4 seeds of each box nearest its center in units of its size
    with torch.no_grad():
        gt_size = (mean_size[labels["size_class_label"]] + labels["size_residual_label"]) \
            * mask[..., None]
        rel = (out["seed_xyz"][:, :, None] - labels["center_label"][:, None]) / (gt_size[:, None]
                                                                                 + 1e-6)
        dist = torch.sqrt((rel ** 2).sum(-1) + 1e-6)
        own = F.one_hot(assign, g).float()
        dist = (dist * own + 100 * (1 - own)).transpose(1, 2)
        near = torch.topk(dist, 4, largest=False)[1]
        kps = torch.zeros(b, s + 1, dtype=torch.long, device=dist.device)
        for bi in range(b):
            for gi in range(g):
                if mask[bi, gi] > 0:
                    kps[bi, near[bi, gi]] = 1
        kps = kps[:, :s] * (inst >= 0).long()
    total = 0.8 * focal(out["kps_logits"], kps)

    q = out["query_inds"]
    q_inst = inst.gather(1, q)
    obj = (q_inst >= 0).float()
    q_assign = torch.where(q_inst < 0, g - 1, q_inst)
    n = obj.sum() + 1e-6
    stages = 0.0
    for prefix in out["stages"]:
        o = {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}
        obj_loss = focal(o["objectness_scores"][..., 0], obj)
        center = (smoothl1(pick(labels["center_label"], q_assign) - o["center"], 0.04)
                  * obj[..., None]).sum() / n
        h_cls = pick(labels["heading_class_label"], q_assign)
        heading_cls = (F.cross_entropy(o["heading_scores"].transpose(1, 2), h_cls,
                                       reduction="none") * obj).sum() / n
        h_res = pick(labels["heading_residual_label"], q_assign) / np.pi
        h_err = o["heading_residuals_normalized"].gather(2, h_cls[..., None])[..., 0] - h_res
        heading_reg = (smoothl1(h_err, 1.0) * obj).sum() / n
        s_cls = pick(labels["size_class_label"], q_assign)
        size_cls = (F.cross_entropy(o["size_scores"].transpose(1, 2), s_cls, reduction="none")
                    * obj).sum() / n
        s_pred = pick_cluster(o["size_residuals_normalized"], s_cls)
        s_label = pick(labels["size_residual_label"], q_assign) / mean_size[s_cls]
        size_reg = (0.111111111111 * smoothl1(s_pred - s_label, 0.111111111111)
                    * obj[..., None]).sum() / n
        sem = (F.cross_entropy(o["sem_cls_scores"].transpose(1, 2),
                               pick(labels["sem_cls_label"], q_assign), reduction="none")
               * obj).sum() / n
        box = center + 0.1 * heading_cls + heading_reg + 0.1 * size_cls + size_reg
        stages = stages + 0.1 * obj_loss + box + 0.1 * sem
    total = total + stages / len(out["stages"])

    last = out["last"]
    boxes = torch.cat([out[last + "center"], out["half_size"] * 2], -1)
    total = total + iou_regression(out["iou_scores"], boxes, labels, mean_size)
    if "iou_scores_jitter" in out:
        total = total + iou_regression(out["iou_scores_jitter"],
                                       torch.cat([out["jitter_center"], out["jitter_size"]], -1),
                                       labels, mean_size)
    return total * 10.0


def pick_cluster(x, cls):
    """x (B, K, NS, 3) at cluster cls (B, K) -> (B, K, 3)."""
    return x.gather(2, cls[:, :, None, None].expand(-1, -1, 1, 3))[:, :, 0]




# ---------------------------------------------------------------- training

def make_optimizer(model: GroupFree, weight_decay: float) -> torch.optim.AdamW:
    """AdamW (betas 0.9, 0.999, eps 1e-8); the parameters whose name holds
    "decoder" in a group of their own, at a tenth of the lr."""
    named = list(model.named_parameters())
    groups = [{"params": [p for n, p in named if "decoder" not in n], "scale": 1.0},
              {"params": [p for n, p in named if "decoder" in n], "scale": 0.1}]
    return torch.optim.AdamW(groups, lr=0.0, weight_decay=weight_decay, foreach=False)


def pretrain_step(model: GroupFree, opt, labels: dict, lr: float, bn_momentum: float,
                  gen) -> float:
    """One step on the batch ``labels`` (its ``point_clouds`` and GT): train
    mode at BN momentum ``bn_momentum``, the jittered forward with ``gen``,
    the loss, the backward, AdamW at ``lr`` (x each group's scale).
    Returns the loss."""
    model.train()
    for m in model.modules():
        if isinstance(m, BN):
            m.momentum = bn_momentum
    for group in opt.param_groups:
        group["lr"] = lr * group["scale"]
    opt.zero_grad(set_to_none=True)
    out = model(labels["point_clouds"], gen, jitter=True)
    total = loss(out, labels, model.mean_size)
    total.backward()
    opt.step()
    return float(total.detach())
