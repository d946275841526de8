"""Group-Free-3D with the GridConv IoU branch.

Liu, Zhang, Cao, Hu and Tong, "Group-Free 3D Object Detection via
Transformers" (ICCV 2021, arXiv:2104.00678; code github.com/zeliu98/
Group-Free-3D, ``models/detector.py``, ``models/transformer.py``,
``models/modules.py``). Channels-last, as the rest of the port:

- the PointNet++ backbone at ``width`` times VoteNet's widths, FP2 giving
  the 1,024 seeds 288-d features (``models/backbone.py``);
- k-point sampling (``model.kps``): a three-conv objectness head on the
  seeds and the top ``num_proposal`` seeds by its sigmoid, in descending
  order, as the queries' points and features;
- a prediction head on the queries (stage ``proposal_``), then
  ``num_decoder_layers`` DETR post-norm decoder layers (``model.decoder``),
  each followed by a head of its own (stages ``0head_`` ... and ``last_``).
  A layer's self-attention position embedding is learned from the previous
  stage's (center, size), detached; its cross-attention one from the seeds'
  xyz, and it is added to the cross-attention's query, key and value, as
  the code does. Every stage's center is the query's point plus the
  predicted residual;
- GridConv on the last stage's detached boxes (HALF sizes,
  ``IoUDetector.calculate_bbox``), reading the seeds' 288-d features.

Each stage's heads are kept under ``<stage><head>``; the last stage's are
also under the plain keys ``parse_predictions`` and the IoU losses read,
with ``objectness_scores`` as the two logits [0, x], whose softmax is the
head's sigmoid, and ``aggregated_vote_xyz`` as the queries' points.

Dropout (p 0.1, in train mode only) draws its masks from the generator the
forward is given, in a fixed order (``TransformerDecoderLayer.forward``),
as the box jitter does, so that a plain reference replays them; the code
draws from the global generator. Attention is written out (products,
softmax, mask) in the module's dtype, f32 with TF32 off on the card.

The parameters keep the release's names (``points_obj_cls``,
``proposal_head``, ``decoder_query_proj``, ``decoder_key_proj``,
``decoder_self_posembeds``, ``decoder_cross_posembeds``, ``decoder``,
``prediction_heads``, and ``nn.MultiheadAttention``'s ``in_proj_weight``,
``in_proj_bias`` and ``out_proj``); the backbone's and GridConv's are the
port's VoteNet names.
"""
import math
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import gather_points
from ..utils import trace
from .backbone import Pointnet2Backbone
from .grid_conv import GridConv
from .mlp import BatchNorm, head_conv
from .votenet import IoUDetector

D_MODEL = 288  # the seeds' feature width and the decoder's


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """``x`` with each element kept where a U(0, 1) draw of ``generator`` is
    at least ``p``, and scaled by 1 / (1 - p); ``generator`` None: ``x``."""
    if generator is None or p == 0.0:
        return x
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return x * ((u >= p).to(x.dtype) * (1.0 / (1.0 - p)))


def _linear(cin: int, cout: int, generator: torch.Generator, bias: str = "uniform"):
    """An (out, in) weight, xavier-uniform as the release's ``init_weights``
    draws the decoder's 2-D weights, and its bias: "uniform" in
    +-1/sqrt(in) (``nn.Linear``'s), "zero" (``nn.MultiheadAttention``'s)."""
    bound = math.sqrt(6.0 / (cin + cout))
    w = torch.empty(cout, cin).uniform_(-bound, bound, generator=generator)
    if bias == "zero":
        return w, torch.zeros(cout)
    b_bound = 1.0 / math.sqrt(cin)
    return w, torch.empty(cout).uniform_(-b_bound, b_bound, generator=generator)


class Linear(nn.Module):
    """``nn.Linear``'s keys (``weight`` (out, in), ``bias``) on channels-last
    input."""

    def __init__(self, cin: int, cout: int, generator: torch.Generator, bias: str = "uniform"):
        super().__init__()
        w, b = _linear(cin, cout, generator, bias)
        self.weight, self.bias = nn.Parameter(w), nn.Parameter(b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention``'s math and keys: the packed (3d, d)
    ``in_proj_weight`` and ``in_proj_bias``, ``out_proj``; q scaled by
    1/sqrt(head dim) before q k^T; dropout on the softmax's weights, its
    mask drawn from the generator."""

    def __init__(self, d: int, nhead: int, p: float, generator: torch.Generator):
        super().__init__()
        self.d, self.nhead, self.p = d, nhead, p
        w, b = _linear(d, 3 * d, generator, bias="zero")
        self.in_proj_weight, self.in_proj_bias = nn.Parameter(w), nn.Parameter(b)
        self.out_proj = Linear(d, d, generator, bias="zero")

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        return x.reshape(b, n, self.nhead, -1).transpose(1, 2)  # (B, H, n, hd)

    def forward(self, query: torch.Tensor, kv: torch.Tensor, self_attention: bool,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        """(B, Lq, d) queries attend to the (B, Lk, d) ``kv`` (the key and the
        value are the same tensor in every call Group-Free makes);
        ``self_attention``: ``kv`` is ``query``, and one product makes q, k
        and v."""
        d = self.d
        w, b = self.in_proj_weight, self.in_proj_bias
        if self_attention:
            q, k, v = F.linear(query, w, b).chunk(3, dim=-1)
        else:
            q = F.linear(query, w[:d], b[:d])
            k, v = F.linear(kv, w[d:], b[d:]).chunk(2, dim=-1)
        q, k, v = self._heads(q), self._heads(k), self._heads(v)
        q = q * (q.shape[-1] ** -0.5)
        attn = torch.softmax(q @ k.transpose(-2, -1), dim=-1)
        attn = dropout(attn, self.p, generator)
        out = (attn @ v).transpose(1, 2).reshape(query.shape)
        return self.out_proj(out)


class TransformerDecoderLayer(nn.Module):
    """DETR's post-norm decoder layer as Group-Free has it
    (``models/transformer.py``): self-attention over the queries with the
    position embedding added to q, k and v; cross-attention from the
    queries (plus their embedding) to the seeds (plus theirs) as key and
    value; a ReLU FFN; each followed by dropout, the residual and a
    LayerNorm (eps 1e-5)."""

    def __init__(self, d: int, nhead: int, dim_feedforward: int, p: float,
                 generator: torch.Generator):
        super().__init__()
        self.p = p
        self.self_attn = MultiheadAttention(d, nhead, p, generator)
        self.multihead_attn = MultiheadAttention(d, nhead, p, generator)
        self.linear1 = Linear(d, dim_feedforward, generator)
        self.linear2 = Linear(dim_feedforward, d, generator)
        self.norm1, self.norm2, self.norm3 = nn.LayerNorm(d), nn.LayerNorm(d), nn.LayerNorm(d)

    def forward(self, query: torch.Tensor, key: torch.Tensor, query_pos: torch.Tensor,
                key_pos: torch.Tensor, generator: Optional[torch.Generator] = None):
        """query (B, K, d), key (B, S, d) and their embeddings -> (B, K, d).
        In train mode ``generator`` draws the dropout masks, in this order:
        the self-attention weights, dropout1, the cross-attention weights,
        dropout2, the FFN's hidden units, dropout3."""
        g = generator if self.training else None
        q = query + query_pos
        query = self.norm1(query + dropout(self.self_attn(q, q, True, g), self.p, g))
        kv = key + key_pos
        query = self.norm2(query + dropout(self.multihead_attn(query + query_pos, kv, False, g),
                                           self.p, g))
        hidden = dropout(F.relu(self.linear1(query)), self.p, g)
        return self.norm3(query + dropout(self.linear2(hidden), self.p, g))


class PositionEmbeddingLearned(nn.Module):
    """Conv1d, BatchNorm, ReLU, Conv1d from the ``cin`` coordinates to
    ``d`` channels (``models/transformer.py``; keys
    ``position_embedding_head.{0,1,3}``)."""

    def __init__(self, cin: int, d: int, generator: torch.Generator):
        super().__init__()
        self.position_embedding_head = nn.Sequential(OrderedDict([
            ("0", head_conv(cin, d, generator)), ("1", BatchNorm(d)), ("2", nn.ReLU()),
            ("3", head_conv(d, d, generator))]))

    def forward(self, xyz: torch.Tensor) -> torch.Tensor:
        return self.position_embedding_head(xyz)


class PointsObjClsModule(nn.Module):
    """The seeds' objectness logit for k-point sampling
    (``models/modules.py``): conv-BN-ReLU twice, then one channel."""

    def __init__(self, d: int, generator: torch.Generator):
        super().__init__()
        self.conv1, self.bn1 = head_conv(d, d, generator), BatchNorm(d)
        self.conv2, self.bn2 = head_conv(d, d, generator), BatchNorm(d)
        self.conv3 = head_conv(d, 1, generator)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        net = F.relu(self.bn1(self.conv1(features)))
        net = F.relu(self.bn2(self.conv2(net)))
        return self.conv3(net)[..., 0]  # (B, S)


class PredictHead(nn.Module):
    """A stage's heads (``models/modules.py::PredictHead``): conv-BN-ReLU
    twice, then one conv a head: objectness (1), center residual (3),
    heading scores and normalised residuals, size scores, normalised size
    residuals (x the class's mean size, no softplus) and class scores."""

    def __init__(self, num_class: int, num_heading_bin: int, num_size_cluster: int,
                 d: int, generator: torch.Generator):
        super().__init__()
        self.num_heading_bin, self.num_size_cluster = num_heading_bin, num_size_cluster
        self.conv1, self.bn1 = head_conv(d, d, generator), BatchNorm(d)
        self.conv2, self.bn2 = head_conv(d, d, generator), BatchNorm(d)
        self.objectness_scores_head = head_conv(d, 1, generator)
        self.center_residual_head = head_conv(d, 3, generator)
        self.heading_class_head = head_conv(d, num_heading_bin, generator)
        self.heading_residual_head = head_conv(d, num_heading_bin, generator)
        self.size_class_head = head_conv(d, num_size_cluster, generator)
        self.size_residual_head = head_conv(d, num_size_cluster * 3, generator)
        self.sem_cls_scores_head = head_conv(d, num_class, generator)

    def forward(self, features: torch.Tensor, base_xyz: torch.Tensor, mean_size: torch.Tensor,
                ep: dict, prefix: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """Writes the stage's heads into ``ep`` under ``prefix``; returns its
        (center, full size at the argmax size class)."""
        b, k = features.shape[:2]
        nh, ns = self.num_heading_bin, self.num_size_cluster
        net = F.relu(self.bn1(self.conv1(features)))
        net = F.relu(self.bn2(self.conv2(net)))
        center = base_xyz + self.center_residual_head(net)
        hrn = self.heading_residual_head(net)
        size_scores = self.size_class_head(net)
        srn = self.size_residual_head(net).reshape(b, k, ns, 3)
        size_residuals = srn * mean_size
        size_class = size_scores.argmax(-1)
        pred_size = torch.gather(size_residuals + mean_size, 2,
                                 size_class[:, :, None, None].expand(-1, -1, 1, 3))[:, :, 0]
        ep[prefix + "base_xyz"] = base_xyz
        ep[prefix + "objectness_scores"] = self.objectness_scores_head(net)
        ep[prefix + "center"] = center
        ep[prefix + "heading_scores"] = self.heading_class_head(net)
        ep[prefix + "heading_residuals_normalized"] = hrn
        ep[prefix + "heading_residuals"] = hrn * (np.pi / nh)
        ep[prefix + "size_scores"] = size_scores
        ep[prefix + "size_residuals_normalized"] = srn
        ep[prefix + "size_residuals"] = size_residuals
        ep[prefix + "pred_size"] = pred_size
        ep[prefix + "sem_cls_scores"] = self.sem_cls_scores_head(net)
        return center, pred_size


def stage_prefixes(num_decoder_layers: int) -> list:
    """The stages' key prefixes in the release's loss order: the proposal,
    the last layer, then the others from the first."""
    if num_decoder_layers == 0:
        return ["proposal_"]
    return ["proposal_", "last_"] + [f"{i}head_" for i in range(num_decoder_layers - 1)]


class GroupFreeDetector(IoUDetector):
    """Group-Free-3D (the module docstring): ``forward_backbone`` here; the
    box decode, GridConv, the jittered training forward and the IoU branch
    alone are ``IoUDetector``'s, as VoteNet's are."""

    HEADS = ("objectness_scores", "center", "heading_scores", "heading_residuals_normalized",
             "heading_residuals", "size_scores", "size_residuals_normalized", "size_residuals",
             "sem_cls_scores")

    def __init__(self, num_class: int, num_heading_bin: int, num_size_cluster: int,
                 mean_size_arr, generator: torch.Generator, input_feature_dim: int = 1,
                 width: int = 1, num_proposal: int = 256, num_decoder_layers: int = 6,
                 sa_npoints=(2048, 1024, 512, 256), nhead: int = 8,
                 dim_feedforward: int = 2048, dropout_p: float = 0.1):
        super().__init__()
        d = D_MODEL
        self.num_proposal, self.num_decoder_layers = num_proposal, num_decoder_layers
        self.num_heading_bin = num_heading_bin
        self.register_buffer(
            "mean_size", torch.as_tensor(np.asarray(mean_size_arr), dtype=torch.float32),
            persistent=False)
        self.backbone_net = Pointnet2Backbone(input_feature_dim, generator, sa_npoints=sa_npoints,
                                              width=width, seed_feat_dim=d)
        self.points_obj_cls = PointsObjClsModule(d, generator)
        self.proposal_head = PredictHead(num_class, num_heading_bin, num_size_cluster, d,
                                         generator)
        self.decoder_key_proj = head_conv(d, d, generator)
        self.decoder_query_proj = head_conv(d, d, generator)
        self.decoder_self_posembeds = nn.ModuleList(
            PositionEmbeddingLearned(6, d, generator) for _ in range(num_decoder_layers))
        self.decoder_cross_posembeds = nn.ModuleList(
            PositionEmbeddingLearned(3, d, generator) for _ in range(num_decoder_layers))
        self.decoder = nn.ModuleList(
            TransformerDecoderLayer(d, nhead, dim_feedforward, dropout_p, generator)
            for _ in range(num_decoder_layers))
        self.prediction_heads = nn.ModuleList(
            PredictHead(num_class, num_heading_bin, num_size_cluster, d, generator)
            for _ in range(num_decoder_layers))
        self.grid_conv = GridConv(num_class, num_heading_bin, num_size_cluster, generator,
                                  seed_feat_dim=d)

    def optimizer_groups(self) -> list:
        """AdamW's parameter groups (``train_dist.py``): every parameter whose
        name holds "decoder" at a tenth of the lr (``lr_scale``, which
        ``train/steps.py`` reads), the rest at the lr."""
        named = list(self.named_parameters())
        return [{"params": [p for n, p in named if "decoder" not in n], "lr_scale": 1.0},
                {"params": [p for n, p in named if "decoder" in n], "lr_scale": 0.1}]

    def forward_backbone(self, point_clouds: torch.Tensor,
                         sa1_inds: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         sample_inds: Optional[torch.Tensor] = None) -> dict:
        """(B, N, 3 + C) -> end points: the backbone, KPS, the proposal head
        and the decoder with its heads. ``generator`` draws the dropout
        masks in train mode; ``sample_inds`` is VoteNet's random
        sampling's and must be None."""
        if sample_inds is not None:
            raise ValueError("Group-Free samples its queries by KPS: sample_inds is VoteNet's")
        ep = self.backbone_net(point_clouds, sa1_inds=sa1_inds)
        seed_xyz, seed_features = ep["fp2_xyz"], ep["fp2_features"]
        ep["seed_inds"], ep["seed_xyz"], ep["seed_features"] = ep["fp2_inds"], seed_xyz, \
            seed_features
        with trace.span("model.kps"):
            logits = self.points_obj_cls(seed_features)
            ep["seeds_obj_cls_logits"] = logits
            inds = torch.topk(torch.sigmoid(logits), self.num_proposal)[1].int()
            query_xyz = gather_points(seed_xyz, inds)
            query_features = gather_points(seed_features, inds)
        ep["query_points_xyz"], ep["query_points_sample_inds"] = query_xyz, inds
        center, size = self.proposal_head(query_features, query_xyz, self.mean_size, ep,
                                          "proposal_")
        last = "proposal_"
        with trace.span("model.decoder", device=True):
            if self.num_decoder_layers:
                query = self.decoder_query_proj(query_features)
                key = self.decoder_key_proj(seed_features)
            for i, layer in enumerate(self.decoder):
                last = "last_" if i == self.num_decoder_layers - 1 else f"{i}head_"
                query_pos = torch.cat([center, size], -1).detach()
                query = layer(query, key, self.decoder_self_posembeds[i](query_pos),
                              self.decoder_cross_posembeds[i](seed_xyz), generator)
                center, size = self.prediction_heads[i](query, query_xyz, self.mean_size, ep,
                                                        last)
        for h in self.HEADS:
            ep[h] = ep[last + h]
        logit = ep["objectness_scores"]
        ep["objectness_scores"] = torch.cat([torch.zeros_like(logit), logit], -1)
        ep["aggregated_vote_xyz"] = query_xyz
        return ep
