"""Group-Free-3D's training loss, with the IoU branch's losses.

The release's ``models/loss_helper.py::get_loss`` (Group-Free-3D, arXiv:
2104.00678) with ``train_dist.py``'s ScanNet settings:

- KPS (``compute_points_obj_cls_loss_hard_topk``, top 4 a box): a seed is
  positive where it lies on an object and is among the 4 seeds of that
  object nearest its box's center, the offsets measured in units of the
  box's size (a box with fewer seeds of its own takes the nearest others);
  a sigmoid focal loss (gamma 2, alpha 0.25) over the seeds' logits, each
  scene's weights 1 / its seeds, summed and divided by the scenes;
- each stage (``models/groupfree.py::stage_prefixes``): objectness of the
  query points (``compute_objectness_loss_based_on_query_points``: a query
  is positive where its seed lies on an object, focal loss as above over
  the queries), and, over the positive queries, each assigned the box of
  its seed's object, the center's smooth-L1 (delta 0.04, summed over xyz),
  heading and size class CE, the heading residual's smooth-L1 (delta 1)
  and the normalised size residual's (delta 0.111, summed over xyz), each
  x its delta, and the semantic class CE;
- loss = 10 x (0.8 KPS + (0.1 objectness + box + 0.1 sem_cls) summed over
  the stages / the stages), box = center + 0.1 heading_cls + heading_reg +
  0.1 size_cls + size_reg.

Smooth-L1 is the release's: 0.5 x^2 / delta below delta, |x| - 0.5 delta
above. The release reads each point's object from the dataset's instance
labels; here a seed's object is the GT box whose center its vote label
points at (the point plus its first vote, the nearest GT center), which
is the instance's box in ScanNet's vote labels, and a seed off every
object is assigned the last GT slot, as the release does.

The IoU branch, this repository's pairing: 10 x (the IoU loss + the
jittered boxes' IoU loss) of ``losses/labeled.py`` on the last stage's
boxes, labelled by the rotated IoU with the GT.

Counters (``utils/trace.py``): ``groupfree.obj_pos``, the queries whose
seed lies on an object, and ``groupfree.kps_pos``, the seeds KPS labels
positive.
"""
import numpy as np
import torch

from ..geometry.nn_distance import huber_loss
from ..models.groupfree import stage_prefixes
from ..utils import trace
from .common import batch_mean, cross_entropy, global_ratio, one_hot
from .iou_labels import placeholder_centers, proposal_gt_iou
from .labeled import _class_iou, _jitter_iou_loss, _take

KPS_TOPK = 4
KPS_WEIGHT, OBJ_WEIGHT, BOX_WEIGHT, SEM_WEIGHT = 0.8, 0.1, 1.0, 0.1
CENTER_DELTA, HEADING_DELTA, SIZE_DELTA = 0.04, 1.0, 0.111111111111
FOCAL_GAMMA, FOCAL_ALPHA = 2.0, 0.25


def smoothl1(error: torch.Tensor, delta: float) -> torch.Tensor:
    diff = error.abs()
    return torch.where(diff < delta, 0.5 * diff * diff / delta, diff - 0.5 * delta)


def focal_loss(logits: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """The sigmoid focal loss of each (B, n) logit, summed with weights 1/n
    a scene and divided by the scenes (``SigmoidFocalClassificationLoss``)."""
    target = label.to(logits.dtype)
    p = torch.sigmoid(logits)
    alpha = target * FOCAL_ALPHA + (1 - target) * (1 - FOCAL_ALPHA)
    pt = target * (1.0 - p) + (1.0 - target) * p
    bce = logits.clamp(min=0) - logits * target + torch.log1p(torch.exp(-logits.abs()))
    b, n = logits.shape
    return (alpha * pt.pow(FOCAL_GAMMA) * bce).sum() / (n * b)


def seed_instances(ep: dict, batch: dict) -> torch.Tensor:
    """(B, S) each seed's GT slot, -1 off every object: the slot whose
    center is nearest the seed plus its first vote."""
    seed_inds = ep["seed_inds"].long()
    on_object = batch["vote_label_mask"].gather(1, seed_inds)
    target = ep["seed_xyz"] + _take(batch["vote_label"], seed_inds)[..., 0:3]
    d = ((target[:, :, None] - placeholder_centers(batch)[:, None]) ** 2).sum(-1)
    return torch.where(on_object > 0, d.argmin(-1), -1)


def kps_label(ep: dict, batch: dict, cfg, instance: torch.Tensor) -> torch.Tensor:
    """(B, S) KPS's labels (the module docstring), without gradient."""
    with torch.no_grad():
        seed_xyz = ep["seed_xyz"]
        b, s = instance.shape
        g = batch["center_label"].shape[1]
        mask = batch["box_label_mask"]
        gt_center = batch["center_label"][..., 0:3]
        gt_size = cfg.class2size_tensor(batch["size_class_label"].long(),
                                        batch["size_residual_label"]) * mask[..., None]
        assigned = one_hot(torch.where(instance < 0, g - 1, instance), g)  # (B, S, G)
        delta = (seed_xyz[:, :, None] - gt_center[:, None]) / (gt_size[:, None] + 1e-6)
        dist = torch.sqrt((delta * delta).sum(-1) + 1e-6)
        dist = dist * assigned + 100.0 * (1.0 - assigned)
        nearest = torch.topk(dist.transpose(1, 2), KPS_TOPK, largest=False)[1]  # (B, G, k)
        nearest = torch.where(mask[..., None] > 0, nearest, s)  # empty slots: the spare column
        label = torch.zeros((b, s + 1), dtype=torch.long, device=seed_xyz.device)
        label.scatter_(1, nearest.reshape(b, -1), 1)
        return torch.where(instance < 0, 0, label[:, :s])


def stage_loss(ep: dict, batch: dict, cfg, prefix: str, assignment: torch.Tensor,
               obj: torch.Tensor) -> tuple:
    """(objectness, box, sem_cls) losses of stage ``prefix``; ``obj`` (B, K)
    float, 1 where the query is positive."""
    nh, ns = cfg.num_heading_bin, cfg.num_size_cluster
    n_obj = obj.sum()
    objectness = focal_loss(ep[prefix + "objectness_scores"][..., 0], obj)

    gt_center = _take(batch["center_label"][..., 0:3], assignment)
    center = global_ratio((smoothl1(gt_center - ep[prefix + "center"], CENTER_DELTA)
                           * obj[..., None]).sum(), n_obj)

    heading_class = _take(batch["heading_class_label"], assignment)
    heading_cls = global_ratio(
        (cross_entropy(ep[prefix + "heading_scores"], heading_class) * obj).sum(), n_obj)
    hr_label = _take(batch["heading_residual_label"], assignment) / (np.pi / nh)
    hr_error = (ep[prefix + "heading_residuals_normalized"] * one_hot(heading_class, nh)).sum(-1) \
        - hr_label
    heading_reg = global_ratio(
        (HEADING_DELTA * smoothl1(hr_error, HEADING_DELTA) * obj).sum(), n_obj)

    size_class = _take(batch["size_class_label"], assignment)
    size_cls = global_ratio(
        (cross_entropy(ep[prefix + "size_scores"], size_class) * obj).sum(), n_obj)
    s_onehot = one_hot(size_class, ns)[..., None]  # (B, K, NS, 1)
    sr_pred = (ep[prefix + "size_residuals_normalized"] * s_onehot).sum(2)
    mean_size = (s_onehot * cfg.mean_size_tensor(obj.device)).sum(2)
    sr_label = _take(batch["size_residual_label"], assignment) / mean_size
    size_reg = global_ratio(
        (SIZE_DELTA * smoothl1(sr_pred - sr_label, SIZE_DELTA) * obj[..., None]).sum(), n_obj)

    sem_cls = global_ratio(
        (cross_entropy(ep[prefix + "sem_cls_scores"], _take(batch["sem_cls_label"], assignment))
         * obj).sum(), n_obj)
    box = center + 0.1 * heading_cls + heading_reg + 0.1 * size_cls + size_reg
    return objectness, box, sem_cls


def get_groupfree_loss(ep: dict, batch: dict, cfg, num_labeled: int):
    """Returns (loss, metrics) over every scene of ``batch``
    (``num_labeled`` scenes: the pretrain step's signature; Group-Free has
    no SSL step here)."""
    if num_labeled != ep["seed_xyz"].shape[0]:
        raise ValueError("Group-Free's loss takes labeled scenes only")
    m = {}
    num_layers = sum(k.endswith("head_center") or k == "last_center" for k in ep)
    instance = seed_instances(ep, batch)
    g = batch["center_label"].shape[1]

    label = kps_label(ep, batch, cfg, instance)
    trace.count("groupfree.kps_pos", label)
    kps = focal_loss(ep["seeds_obj_cls_logits"], label)
    m["kps_loss"] = kps
    m["kps_pos_ratio"] = batch_mean(label.float())

    query_inds = ep["query_points_sample_inds"].long()
    query_instance = instance.gather(1, query_inds)
    obj = (query_instance >= 0).float()
    trace.count("groupfree.obj_pos", obj)
    assignment = torch.where(query_instance < 0, g - 1, query_instance)
    m["pos_ratio"] = batch_mean(obj)
    sums = [0.0, 0.0, 0.0]
    for prefix in stage_prefixes(num_layers):
        losses = stage_loss(ep, batch, cfg, prefix, assignment, obj)
        for i, x in enumerate(losses):
            sums[i] = sums[i] + x
    obj_sum, box_sum, sem_sum = sums
    m["sum_heads_objectness_loss"], m["sum_heads_box_loss"] = obj_sum, box_sum
    m["sum_heads_sem_cls_loss"] = sem_sum
    total = KPS_WEIGHT * kps + (OBJ_WEIGHT * obj_sum + BOX_WEIGHT * box_sum
                                + SEM_WEIGHT * sem_sum) / (num_layers + 1)
    m["detection_loss"] = total * 10.0

    iou_labels, iou_assignment = proposal_gt_iou(
        batch, ep["center"], ep["heading_scores"], ep["heading_residuals"], ep["size_scores"],
        ep["size_residuals"], cfg).max(-1)
    iou_pred = _class_iou(ep["iou_scores"], _take(batch["sem_cls_label"], iou_assignment))
    iou_loss = batch_mean(huber_loss(iou_pred - iou_labels, 1.0))
    m["iou_loss"] = iou_loss
    m["iou_acc"] = batch_mean((iou_pred - iou_labels).abs())
    total = total + iou_loss
    if "iou_scores_jitter" in ep:
        jitter = _jitter_iou_loss(ep, batch, num_labeled, cfg, m)
        m["jitter_iou_loss"] = jitter
        total = total + jitter
    return total * 10.0, m


def get_groupfree_eval_loss(ep: dict, batch: dict, cfg):
    """The eval path's loss (``train/steps.py::make_eval_loss``): the
    training loss on an eval forward, which has no jittered boxes."""
    return get_groupfree_loss(ep, batch, cfg, batch["center_label"].shape[0])
