"""The work of a step or a request, from the configuration's shapes alone.

``linears`` lists every SharedMLP and head convolution of one VoteNet-IoU
forward (rows, in, out); ``model_flops`` turns a mix's step or request into
model FLOPs; ``kernel_calls`` lists the hand kernels' calls with the shapes
they take. Nothing is read from the program, so a change to the program
cannot move these counts.
"""
GRID_POINTS = 64  # GridConv's 4 x 4 x 4 lattice a box


def _mlp(name, rows, chans):
    return [(f"{name}.{i}", rows, cin, cout) for i, (cin, cout) in
            enumerate(zip(chans[:-1], chans[1:]))]


def linears(c: dict, b: int, grid_boxes: int) -> list:
    """(name, rows, in, out) of every 1x1 convolution of one forward over
    ``b`` scenes, GridConv on ``grid_boxes`` boxes a scene. Names start with
    ``detector.`` (backbone, voting, proposal) or ``iou.`` (GridConv)."""
    npt, ns, mlps = c["sa_npoints"], c["sa_nsamples"], c["sa_mlps"]
    k, fd, sf = c["num_proposal"], c["input_feature_dim"], c["seed_feat_dim"]
    nh, nsz, nc = c["num_heading_bin"], c["num_size_cluster"], c["num_class"]
    out = []
    cin = fd
    for i in range(4):
        out += _mlp(f"detector.sa{i + 1}", b * npt[i] * ns[i], [3 + cin] + mlps[i])
        cin = mlps[i][-1]
    out += _mlp("detector.fp1", b * npt[2], [mlps[3][-1] + mlps[2][-1]] + c["fp_mlps"][0])
    out += _mlp("detector.fp2", b * npt[1], [c["fp_mlps"][0][-1] + mlps[1][-1]] + c["fp_mlps"][1])
    out += _mlp("detector.vote", b * npt[1], [sf] + c["vote_mlp"] + [(3 + sf) * c["vote_factor"]])
    out += _mlp("detector.agg", b * k * c["agg_nsample"], [3 + sf] + c["agg_mlp"])
    out += _mlp("detector.proposal", b * k, [c["agg_mlp"][-1]] + c["proposal_mlp"]
                + [2 + 3 + nh * 2 + nsz * 4 + nc])
    out += _mlp("iou.grid", b * grid_boxes * GRID_POINTS, [3 + sf] + c["grid_mlp"])
    out += _mlp("iou.head", b * grid_boxes, [c["grid_mlp"][-1]] + c["iou_head_mlp"]
                + [3 + nh * 2 + nsz * 3 + nc])
    return out


def flops(layers, prefix: str = "") -> float:
    return float(sum(2 * rows * cin * cout for name, rows, cin, cout in layers
                     if name.startswith(prefix)))


def model_flops(c: dict, mix: dict) -> float:
    """Model FLOPs of one step or request of the mix: 2 x the MACs of a
    forward; a trained forward's backward twice its forward; the teacher
    forward only; in training GridConv runs on the boxes and their jittered
    copies (2K a scene). ``iou_optimize`` runs opt_step + 1 GridConv
    forwards, each with its backward to the boxes alone (one product a
    layer: once the forward), and one forward more."""
    k = c["num_proposal"]
    if mix["driver"] == "train":
        b = mix["labeled"] + mix["unlabeled"] if mix["step"] == "ssl" else mix["batch"]
        fwd = flops(linears(c, b, 2 * k))
        return fwd * 3 + (fwd if mix["step"] == "ssl" else 0.0)
    b = mix["batch"]
    total = flops(linears(c, b, k))
    if mix.get("opt_step", 0) > 0:
        grid = flops(linears(c, b, k), "iou.")
        total += (mix["opt_step"] + 1) * 2 * grid + grid
    return total


def _forward_calls(c: dict, b: int, grid_boxes: int, fps: bool, backward: bool) -> list:
    n, npt, ns, mlps = c["num_point"], c["sa_npoints"], c["sa_nsamples"], c["sa_mlps"]
    k, sf, fd = c["num_proposal"], c["seed_feat_dim"], c["input_feature_dim"]
    votes = npt[1] * c["vote_factor"]
    calls = [("fps", dict(b=b, n=n, npoint=npt[0]))] if fps else []
    pts = [n] + list(npt)
    width = [3 + fd] + [3 + m[-1] for m in mlps]
    for i in range(4):
        calls.append(("ball_query", dict(b=b, n=pts[i], m=npt[i], ns=ns[i])))
        calls.append(("gather", dict(b=b, n=pts[i], c=width[i], q=npt[i] * ns[i])))
        if backward and i > 0:
            calls.append(("gather_bwd", dict(b=b, n=pts[i], c=width[i], q=npt[i] * ns[i])))
    for fp, (n_, m_, cf, cs) in enumerate(((npt[2], npt[3], mlps[3][-1], mlps[2][-1]),
                                           (npt[1], npt[2], c["fp_mlps"][0][-1], mlps[1][-1]))):
        calls.append(("three_nn", dict(b=b, n=n_, m=m_)))
        calls.append(("three_interpolate", dict(b=b, n=n_, m=m_, c=cf, skip=cs)))
        if backward:
            calls.append(("three_interpolate_bwd", dict(b=b, n=n_, m=m_, c=cf)))
    calls.append(("ball_query", dict(b=b, n=votes, m=k, ns=c["agg_nsample"])))
    calls.append(("gather", dict(b=b, n=votes, c=3 + sf, q=k * c["agg_nsample"])))
    if backward:
        calls.append(("gather_bwd", dict(b=b, n=votes, c=3 + sf, q=k * c["agg_nsample"])))
    calls += _grid_calls(c, b, grid_boxes)
    return calls


def _grid_calls(c: dict, b: int, boxes: int) -> list:
    q = boxes * GRID_POINTS
    seeds = c["sa_npoints"][1]
    return [("three_nn", dict(b=b, n=q, m=seeds)),
            ("gather", dict(b=b, n=seeds, c=3 + c["seed_feat_dim"], q=q * 3))]


def kernel_calls(c: dict, mix: dict) -> list:
    """(kernel, shape) of every hand-kernel call of one step or request
    whose work follows from shapes; the IoU, LHS and NMS kernels, whose work
    depends on the boxes, are left out."""
    k = c["num_proposal"]
    if mix["driver"] == "train":
        if mix["step"] == "ssl":
            b = mix["labeled"] + mix["unlabeled"]
            calls = [("fps", dict(b=2 * b, n=c["num_point"], npoint=c["sa_npoints"][0]))]
            calls += _forward_calls(c, b, 2 * k, fps=False, backward=False)  # the teacher
            return calls + _forward_calls(c, b, 2 * k, fps=False, backward=True)
        return _forward_calls(c, mix["batch"], 2 * k, fps=True, backward=True)
    b = mix["batch"]
    calls = _forward_calls(c, b, k, fps=True, backward=False)
    if mix.get("opt_step", 0) > 0:
        for _ in range(mix["opt_step"] + 2):
            calls += _grid_calls(c, b, k)
    return calls
