"""The traffic generator: synthetic indoor scenes and the batches a mix
asks for, all drawn from ``--seed``.

A scene is a room of ``num_point`` points (``configs/``): a share
``scene.in_boxes`` of them inside the scene's GT boxes (within 0.95 of
their half extents), the rest on the floor and the four walls, uniform by
area, as ``chip_smoke.py::make_surface_scenes`` and ``sunrgbd_frame`` make
them. The boxes are of the configuration's classes, sized the class mean
x U(0.8, 1.2), standing on the floor, turned about z uniformly where the
configuration has heading bins (SUN RGB-D) and axis-aligned where it has
one (ScanNet). The labels are the datasets' (``scannet/scannet_detection_
dataset.py``, ``sunrgbd/sunrgbd_detection_dataset.py``): GT slots up to
``max_num_obj``, every point drawn inside a box voting for that box's center, the vote
tiled x3, and the height channel (z less the 0.99 percentile of z).

Every seed gives the same shapes and the same number of points and GT
slots; only the content changes. Nothing here imports the program.
"""
import numpy as np

G_VOTES = 3


def angle2class(angle: np.ndarray, num_bins: int):
    """Headings -> (bin, residual from the bin's center), as
    ``sunrgbd/model_util_sunrgbd.py::angle2class``."""
    per = 2 * np.pi / num_bins
    shifted = (np.mod(angle, 2 * np.pi) + per / 2) % (2 * np.pi)
    cls = (shifted / per).astype(np.int64)
    return cls, shifted - (cls * per + per / 2)


def scene(rng: np.random.Generator, config: dict, mix: dict, m: int, width: float,
          depth: float) -> dict:
    """One scene of ``m`` boxes in a ``width`` x ``depth`` room: its point
    cloud and labels (NumPy)."""
    n, g = config["num_point"], config["max_num_obj"]
    mean = np.asarray(config["mean_size_arr"], np.float64)
    nh = config["num_heading_bin"]
    sc = mix["scene"]
    cls = rng.integers(0, config["num_class"], m)
    size = mean[cls] * rng.uniform(0.8, 1.2, (m, 3))
    heading = rng.uniform(-np.pi, np.pi, m) if nh > 1 else np.zeros(m)
    center = np.stack([rng.uniform(-width / 2 + 0.5, width / 2 - 0.5, m),
                       rng.uniform(-depth / 2 + 0.5, depth / 2 - 0.5, m),
                       size[:, 2] / 2 + rng.uniform(0.0, 0.3, m)], -1)
    # points inside the boxes
    nb = int(n * sc["in_boxes"])
    owner = rng.integers(0, m, nb)
    local = rng.uniform(-0.95, 0.95, (nb, 3)) * size[owner] / 2
    c, s = np.cos(heading[owner]), np.sin(heading[owner])
    box_xyz = np.stack([c * local[:, 0] - s * local[:, 1], s * local[:, 0] + c * local[:, 1],
                        local[:, 2]], -1) + center[owner]
    # the floor (its area's share) and four walls
    nr = n - nb
    h = sc["height"]
    areas = np.array([width * depth, depth * h, depth * h, width * h, width * h])
    face = rng.choice(5, nr, p=areas / areas.sum())
    u, v = rng.uniform(-0.5, 0.5, (2, nr))
    z = rng.uniform(0.0, h, nr)
    x = np.select([face == 1, face == 2], [-width / 2, width / 2], u * width)
    y = np.select([face == 0, (face == 1) | (face == 2), face == 3],
                  [v * depth, u * depth, -depth / 2], depth / 2)
    room = np.stack([x, y, np.where(face == 0, 0.0, z)], -1)
    perm = rng.permutation(n)
    xyz = np.concatenate([box_xyz, room])[perm]
    floor = np.percentile(xyz[:, 2], 0.99)
    pc = np.concatenate([xyz, (xyz[:, 2] - floor)[:, None]], -1).astype(np.float32)
    # votes: each point drawn inside a box votes for that box's center
    hit = perm < nb
    vote = center[owner[perm[hit]]] - xyz[hit]
    vote_label = np.zeros((n, 3 * G_VOTES), np.float32)
    vote_label[hit] = np.tile(vote, G_VOTES)

    lab = {k: np.zeros(s_, t) for k, s_, t in (
        ("center_label", (g, 3), np.float32), ("box_label_mask", (g,), np.float32),
        ("heading_class_label", (g,), np.int64), ("heading_residual_label", (g,), np.float32),
        ("size_class_label", (g,), np.int64), ("size_residual_label", (g, 3), np.float32),
        ("sem_cls_label", (g,), np.int64))}
    lab["center_label"][:m] = center
    lab["box_label_mask"][:m] = 1
    if nh > 1:
        hc, hr = angle2class(heading, nh)
        lab["heading_class_label"][:m] = hc
        lab["heading_residual_label"][:m] = hr
    lab["size_class_label"][:m] = cls
    lab["size_residual_label"][:m] = size - mean[cls]
    lab["sem_cls_label"][:m] = cls
    lab["point_clouds"] = pc
    lab["vote_label"] = vote_label
    lab["vote_label_mask"] = hit.astype(np.int64)
    return lab


def collate(scenes: list) -> dict:
    return {k: np.stack([s[k] for s in scenes]) for k in scenes[0]}


def augment(rng: np.random.Generator, pc: np.ndarray, aug: dict) -> tuple:
    """The student's view of ``pc`` (b, N, C): x and y flipped each with its
    probability, turned about z within ``rotate_deg`` and scaled within
    ``scale``, as the SSL datasets augment an unlabeled scene. Returns
    (clouds, the batch keys that describe the augmentation)."""
    b = pc.shape[0]
    flip_x = (rng.random(b) < aug["flip_x"]).astype(np.int64)
    flip_y = (rng.random(b) < aug["flip_y"]).astype(np.int64)
    lim = np.deg2rad(aug["rotate_deg"])
    angle = rng.uniform(-lim, lim, b).astype(np.float32)
    rot = np.zeros((b, 3, 3), np.float32)
    rot[:, 0, 0], rot[:, 0, 1], rot[:, 2, 2] = np.cos(angle), -np.sin(angle), 1.0
    rot[:, 1, 0], rot[:, 1, 1] = np.sin(angle), np.cos(angle)
    scale = np.tile(rng.uniform(aug["scale"][0], aug["scale"][1], (b, 1, 1)),
                    (1, 1, 3)).astype(np.float32)
    sign = np.where(np.stack([flip_x, flip_y, np.zeros(b)], -1) > 0, -1.0, 1.0)[:, None]
    out = pc.copy()
    out[..., 0:3] = np.einsum("bnc,bdc->bnd", pc[..., 0:3] * sign, rot) * scale
    return out.astype(np.float32), {"flip_x_axis": flip_x, "flip_y_axis": flip_y,
                                    "rot_mat": rot, "rot_angle": angle, "scale": scale}


def identity_augmentation(b: int) -> dict:
    return {"flip_x_axis": np.zeros(b, np.int64), "flip_y_axis": np.zeros(b, np.int64),
            "rot_mat": np.tile(np.eye(3, dtype=np.float32), (b, 1, 1)),
            "rot_angle": np.zeros(b, np.float32), "scale": np.ones((b, 1, 3), np.float32)}


def layouts(rng: np.random.Generator, n: int, mix: dict) -> list:
    """(boxes, width, depth) of ``n`` scenes: the same set for every seed,
    the seed deciding only their order. The box counts run through
    ``scene.boxes`` in turn and the room sides through evenly spaced
    points of ``scene.room``, so that every seed's pool holds the same
    work (the ball queries' early exit follows the points' density)."""
    lo, hi = mix["scene"]["boxes"]
    r0, r1 = mix["scene"]["room"]
    side = [r0 + (r1 - r0) * (i + 0.5) / n for i in range(n)]
    stride = next(k for k in range(n // 2 + 1, n + 1) if np.gcd(k, n) == 1) if n > 2 else 1
    sets = [(lo + i % (hi - lo + 1), side[i], side[(i * stride) % n]) for i in range(n)]
    return [sets[i] for i in rng.permutation(n)]


def batch(rng: np.random.Generator, config: dict, mix: dict, layout: list) -> dict:
    """One batch of the mix from its scenes' ``layout``: ``batch`` scenes
    with their labels; for the SSL step ``labeled`` + ``unlabeled`` scenes,
    the teacher's clouds as made and the student's with the unlabeled
    scenes augmented (the labeled ones as they are, so that their labels
    hold in the student's frame), every scene's labels kept (view-stats
    reads the unlabeled ones', in the teacher's frame)."""
    scenes = collate([scene(rng, config, mix, *x) for x in layout])
    if mix["driver"] == "train" and mix["step"] == "ssl":
        nl = mix["labeled"]
        scenes["ema_point_clouds"] = scenes["point_clouds"]
        student, aug = augment(rng, scenes["point_clouds"][nl:], mix["augment"])
        ident = identity_augmentation(nl)
        scenes["point_clouds"] = np.concatenate([scenes["point_clouds"][:nl], student])
        scenes.update({k: np.concatenate([ident[k], aug[k]]) for k in aug})
    return scenes


def batches(seed: int, config: dict, mix: dict) -> list:
    """The mix's pool of ``pool`` distinct batches from ``seed``: the
    window cycles through them, the first steps take the first ones."""
    rng = np.random.default_rng(seed)
    b = scenes_of(mix)
    lay = layouts(rng, mix["pool"] * b, mix)
    return [batch(rng, config, mix, lay[i * b:(i + 1) * b]) for i in range(mix["pool"])]


def scenes_of(mix: dict) -> int:
    """Scenes a step or a request carries."""
    if mix["driver"] == "train" and mix["step"] == "ssl":
        return mix["labeled"] + mix["unlabeled"]
    return mix["batch"]
