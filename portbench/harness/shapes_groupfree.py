"""The work of a Group-Free-3D pretrain step, from the configuration's
shapes alone (``configs/scannet-groupfree-l12-w2x-iou.json``), as
``shapes.py`` counts VoteNet's.

``linears`` lists every product of one forward as (name, rows, in, out),
2 x rows x in x out FLOPs: the backbone's shared MLPs, KPS's head, the
prediction heads, the decoder's projections, position embeddings,
attention products (q k^T and the weights times v, each b x Lq x Lk x d
multiply-adds over the heads) and FFN, and GridConv. ``model_flops`` is a
step's: the forward and a backward of twice its products.
``kernel_calls`` lists the hand kernels' calls with the shapes they take.
Nothing is read from the program."""
from .shapes import GRID_POINTS, _mlp, flops


def head_out(c: dict) -> int:
    """A prediction head's output channels: objectness, center, heading
    scores and residuals, size scores and residuals, class scores."""
    nh, ns = c["num_heading_bin"], c["num_size_cluster"]
    return 1 + 3 + 2 * nh + 4 * ns + c["num_class"]


def _head(name: str, rows: int, c: dict) -> list:
    d = c["d_model"]
    return [(f"{name}.conv1", rows, d, d), (f"{name}.conv2", rows, d, d),
            (f"{name}.out", rows, d, head_out(c))]


def decoder_layer(c: dict, b: int, i: int) -> list:
    """The products of decoder layer ``i`` over ``b`` scenes, its position
    embeddings and its prediction head included."""
    k, s = c["num_target"], c["sa_npoints"][1]
    d, ff = c["d_model"], c["dim_feedforward"]
    q, kv = b * k, b * s
    name = f"decoder.{i}"
    return [
        (f"{name}.self_pos.0", q, 6, d), (f"{name}.self_pos.3", q, d, d),
        (f"{name}.cross_pos.0", kv, 3, d), (f"{name}.cross_pos.3", kv, d, d),
        (f"{name}.self.in_proj", q, d, 3 * d),
        (f"{name}.self.qk", q, d, k), (f"{name}.self.av", q, d, k),
        (f"{name}.self.out_proj", q, d, d),
        (f"{name}.cross.q", q, d, d), (f"{name}.cross.kv", kv, d, 2 * d),
        (f"{name}.cross.qk", q, d, s), (f"{name}.cross.av", q, d, s),
        (f"{name}.cross.out_proj", q, d, d),
        (f"{name}.linear1", q, d, ff), (f"{name}.linear2", q, ff, d),
    ] + _head(f"{name}.head", q, c)


def linears(c: dict, b: int, grid_boxes: int) -> list:
    """(name, rows, in, out) of every product of one forward over ``b``
    scenes, GridConv on ``grid_boxes`` boxes a scene. Names start with
    ``detector.`` (backbone, KPS, proposal head), ``decoder.`` (the
    projections and the layers with their heads) or ``iou.`` (GridConv)."""
    npt, ns, mlps = c["sa_npoints"], c["sa_nsamples"], c["sa_mlps"]
    k, s, d = c["num_target"], npt[1], c["d_model"]
    out, cin = [], c["input_feature_dim"]
    for i in range(4):
        out += _mlp(f"detector.sa{i + 1}", b * npt[i] * ns[i], [3 + cin] + mlps[i])
        cin = mlps[i][-1]
    out += _mlp("detector.fp1", b * npt[2], [mlps[3][-1] + mlps[2][-1]] + c["fp_mlps"][0])
    out += _mlp("detector.fp2", b * npt[1], [c["fp_mlps"][0][-1] + mlps[1][-1]] + c["fp_mlps"][1])
    out += [("detector.kps.conv1", b * s, d, d), ("detector.kps.conv2", b * s, d, d),
            ("detector.kps.conv3", b * s, d, 1)]
    out += _head("detector.proposal", b * k, c)
    out += [("decoder.key_proj", b * s, d, d), ("decoder.query_proj", b * k, d, d)]
    for i in range(c["num_decoder_layers"]):
        out += decoder_layer(c, b, i)
    out += _mlp("iou.grid", b * grid_boxes * GRID_POINTS, [3 + c["seed_feat_dim"]] + c["grid_mlp"])
    out += _mlp("iou.head", b * grid_boxes, [c["grid_mlp"][-1]] + c["iou_head_mlp"]
                + [3 + 2 * c["num_heading_bin"] + 3 * c["num_size_cluster"] + c["num_class"]])
    return out


def model_flops(c: dict, mix: dict) -> float:
    """Model FLOPs of one pretrain step: the forward over the batch, GridConv
    on the boxes and their jittered copies (2K a scene), and a backward of
    twice the forward's products."""
    return 3 * flops(linears(c, mix["batch"], 2 * c["num_target"]))


def kernel_calls(c: dict, mix: dict) -> list:
    """(kernel, shape) of every hand-kernel call of one pretrain step whose
    work follows from shapes (the IoU labels' kernel, whose work depends
    on the boxes, is left out): SA1's FPS, each SA's ball query and gather
    (and the gather's backward where its table takes a gradient: SA2-SA4),
    each FP's three_nn, interpolation and its backward, and GridConv's
    three_nn and gather over the seeds."""
    b, n, npt, ns = mix["batch"], c["num_point"], c["sa_npoints"], c["sa_nsamples"]
    mlps, fd = c["sa_mlps"], c["input_feature_dim"]
    calls = [("fps", dict(b=b, n=n, npoint=npt[0]))]
    pts = [n] + list(npt)
    width = [3 + fd] + [3 + m[-1] for m in mlps]
    for i in range(4):
        calls.append(("ball_query", dict(b=b, n=pts[i], m=npt[i], ns=ns[i])))
        calls.append(("gather", dict(b=b, n=pts[i], c=width[i], q=npt[i] * ns[i])))
        if i > 0:
            calls.append(("gather_bwd", dict(b=b, n=pts[i], c=width[i], q=npt[i] * ns[i])))
    for n_, m_, cf, cs in ((npt[2], npt[3], mlps[3][-1], mlps[2][-1]),
                           (npt[1], npt[2], c["fp_mlps"][0][-1], mlps[1][-1])):
        calls.append(("three_nn", dict(b=b, n=n_, m=m_)))
        calls.append(("three_interpolate", dict(b=b, n=n_, m=m_, c=cf, skip=cs)))
        calls.append(("three_interpolate_bwd", dict(b=b, n=n_, m=m_, c=cf)))
    q = 2 * c["num_target"] * GRID_POINTS
    calls.append(("three_nn", dict(b=b, n=q, m=npt[1])))
    calls.append(("gather", dict(b=b, n=npt[1], c=3 + c["seed_feat_dim"], q=q * 3)))
    return calls


def roofline_pct(reading, c: dict, mix: dict):
    """``reading.roofline_pct`` over this model's calls: the sum of the
    bounds over the sum of device time of the hand kernels with a bound
    from shapes, each counted only where its launches in the traced
    section are those its calls make."""
    profile, units = reading.profile, reading.traced_units
    if not profile or not units:
        return None
    calls = {}
    for kernel, shape in kernel_calls(c, mix):
        mod = reading.kernel_modules.get(kernel)
        if mod is None or mod.bound_s is None:
            continue
        n, bound = calls.get(kernel, (0, 0.0))
        calls[kernel] = (n + 1, bound + mod.bound_s(shape, reading.peaks))
    bound = spent = 0.0
    for kernel, (n, b) in calls.items():
        per_call = getattr(reading.kernel_modules[kernel], "LAUNCHES", 1)
        if profile["launches"].get(kernel, 0) != n * per_call * units:
            continue
        bound += b * units
        spent += profile["by_kernel"][kernel]
    return None if spent <= 0 else 100.0 * bound / spent


def mfu_pct(reading, c: dict, mix: dict):
    """Model FLOPs of the window's steps outside the profiled section over
    that time and the float32 peak."""
    if not reading.window_units or reading.window_s <= 0:
        return None
    work = model_flops(c, mix) * reading.window_units
    return 100.0 * work / reading.window_s / reading.peaks["flops"][c["precision"]]
