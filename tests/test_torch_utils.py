"""The port's logs, TensorBoard records, PLY dumps and metrics against the
JAX package's, on the CPU.

- ``Logger``: ``log_train.txt`` and ``best.txt`` byte for byte.
- ``TBWriter`` and ``Visualizer``: with the wall clock pinned in both
  packages (one ``time.time`` for both), every Summary.Value of scalars,
  grouped scalars and histograms is byte for byte the JAX encoder's. The
  JAX writer puts a Value's fields straight into the Summary, so
  TensorBoard cannot parse its events (a fault of the JAX package, shown
  here and recorded in ROADMAP Queue 3); the port's event files are, byte
  for byte, the JAX encoders' Values each framed as ``Summary.value`` (1),
  and TensorBoard's own ``event_pb2`` reads back their tags and values.
  Images: the port encodes PNG with ``zlib`` and the JAX writer with PIL, so
  the bytes differ; each record's framing checks, its tags and
  Summary.Image header (height, width, colorspace) are equal, and its PNG
  decodes (by PIL, here only) to the same pixels.
- ``dump_helper``: every PLY writer and ``dump_results`` (ScanNet and SUN
  RGB-D, with GT, NumPy and tensor inputs) byte for byte.
- Precision and recall: ``tests/test_utils.py``'s cases and random scenes,
  equal.
- ``viz_votes``, ``viz_obb`` (both datasets) byte for byte, and
  ``get_sem_cls_statistics`` on a fake SUN RGB-D dump, equal.
"""
import glob
import io
import os
import struct
import sys

import numpy as np
import pytest
import torch

from iou3dmatch_tpu.data.config import get_config as jax_get_config
from iou3dmatch_tpu.utils import dump_helper as jdump
from iou3dmatch_tpu.utils import logger as jlogger
from iou3dmatch_tpu.utils import metrics as jmetrics
from iou3dmatch_tpu.utils import tb_writer as jtb

from iou3dmatch_tpu_torch.data.config import get_config
from iou3dmatch_tpu_torch.utils import dump_helper as pdump
from iou3dmatch_tpu_torch.utils import logger as plogger
from iou3dmatch_tpu_torch.utils import metrics as pmetrics
from iou3dmatch_tpu_torch.utils import tb_writer as ptb

sys.path.insert(0, os.path.dirname(__file__))
from data_cases import write_sunrgbd_dump  # noqa: E402

WALL = 1700000000.25  # the pinned wall clock


def _same_files(a, b):
    """Both directories hold the same file names, each byte for byte."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for n in names:
        assert open(os.path.join(a, n), "rb").read() == open(os.path.join(b, n), "rb").read(), n


def _records(path):
    data = open(path, "rb").read()
    off, recs = 0, []
    while off < len(data):
        hdr = data[off:off + 8]
        ln = struct.unpack("<Q", hdr)[0]
        assert struct.unpack("<I", data[off + 8:off + 12])[0] == ptb._masked_crc(hdr)
        payload = data[off + 12:off + 12 + ln]
        assert struct.unpack("<I", data[off + 12 + ln:off + 16 + ln])[0] == ptb._masked_crc(payload)
        recs.append(payload)
        off += 16 + ln
    return recs


def _fields(buf):
    """A protobuf message -> [(field, value)]: varints as ints,
    length-delimited fields as bytes, fixed 64/32-bit as raw bytes."""
    out, i = [], 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
        elif wire == 1:
            v, i = buf[i:i + 8], i + 8
        elif wire == 2:
            n, i = _read_varint(buf, i)
            v, i = buf[i:i + n], i + n
        elif wire == 5:
            v, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(wire)
        out.append((field, v))
    return out


def _read_varint(buf, i):
    shift = n = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n, i


def _event_file(d):
    files = glob.glob(os.path.join(d, "events.out.tfevents.*"))
    assert len(files) == 1
    return files[0]


def test_logger_files_equal_jax(tmp_path, capsys):
    for mod, d in ((jlogger, tmp_path / "jax"), (plogger, tmp_path / "port")):
        lg = mod.Logger(str(d))
        lg("**** EPOCH 000 ****  lr 0.001000  bn_momentum 0.5000")
        lg.log(" batch 0001 loss: 1.2345")
        lg.log_best("epoch 1: mAP sum 0.1234")
        lg.log_best("epoch 2: mAP sum 0.2345")  # overwrites
        lg.close()
        mod.Logger(str(d))("appended by a second run")
    _same_files(tmp_path / "jax", tmp_path / "port")
    assert open(tmp_path / "port" / "best.txt").read() == "epoch 2: mAP sum 0.2345\n"
    assert capsys.readouterr().out.count("appended by a second run") == 2


def _frame(data):
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", jtb._masked_crc(header)) + data
            + struct.pack("<I", jtb._masked_crc(data)))


def _jax_event(step, values=(), file_version="", wrap=True):
    """An event from the JAX encoders: ``wrap`` frames each Value as
    Summary.value, as TensorBoard reads it; without, the JAX writer's form."""
    ev = jtb._double(1, WALL) + jtb._int64(2, step)
    if file_version:
        ev += jtb._len_delim(3, file_version.encode())
    if values:
        ev += jtb._len_delim(5, b"".join(jtb._len_delim(1, v) if wrap else v for v in values))
    return ev


def _tb_script():
    rng = np.random.RandomState(0)
    hist = [(rng.randn(100), 30), (rng.uniform(0, 3, (7, 9)), 30), (np.arange(5), 12)]
    calls = [("scalar_summary", ("loss/total", 1.5), 3),
             ("scalars", ({"a": 1.0, "b": -2.25, "c": np.float32(0.1)},), 4)]
    calls += [("histo_summary", (f"h{i}", v, 5 + i, bins), None) for i, (v, bins) in enumerate(hist)]
    calls.append(("scalar_summary", ("big_step", 3.0), 2 ** 40))
    events = [(0, [], "brain.Event:2"), (3, [jtb._scalar_value("loss/total", 1.5)], ""),
              (4, [jtb._scalar_value(t, v) for t, v in calls[1][1][0].items()], "")]
    events += [(5 + i, [jtb._histo_value(f"h{i}", v, bins)], "") for i, (v, bins) in enumerate(hist)]
    events.append((2 ** 40, [jtb._scalar_value("big_step", 3.0)], ""))
    return calls, events


def test_tb_records_are_the_jax_values_framed_for_tensorboard(tmp_path, monkeypatch):
    monkeypatch.setattr(ptb.time, "time", lambda: WALL)  # the one time module of both
    calls, events = _tb_script()
    for mod, d in ((jtb, tmp_path / "jax"), (ptb, tmp_path / "port")):
        w = mod.TBWriter(str(d))
        for name, args, step in calls:
            getattr(w, name)(*args, **({} if step is None else {"step": step}))
        w.close()
    jfile, pfile = _event_file(tmp_path / "jax"), _event_file(tmp_path / "port")
    assert os.path.basename(jfile) == os.path.basename(pfile)
    # the JAX file: its own unwrapped form of the same Values, byte for byte
    assert open(jfile, "rb").read() == b"".join(
        _frame(_jax_event(s, v, f, wrap=False)) for s, v, f in events)
    assert open(pfile, "rb").read() == b"".join(_frame(_jax_event(s, v, f)) for s, v, f in events)

    event_pb2 = pytest.importorskip("tensorboard.compat.proto.event_pb2")
    from google.protobuf.message import DecodeError

    recs = _records(pfile)
    parsed = []
    for rec in recs:
        e = event_pb2.Event()
        e.ParseFromString(rec)
        parsed.append(e)
    assert parsed[0].file_version == "brain.Event:2" and parsed[0].wall_time == WALL
    assert [(v.tag, v.simple_value) for v in parsed[2].summary.value] == [
        ("a", 1.0), ("b", -2.25), ("c", np.float32(0.1))]
    h = parsed[3].summary.value[0].histo
    assert (parsed[3].summary.value[0].tag, parsed[3].step, h.num, len(h.bucket)) == ("h0", 5, 100, 30)
    assert parsed[-1].step == 2 ** 40
    with pytest.raises(DecodeError):  # the JAX package's events
        event_pb2.Event().ParseFromString(_records(jfile)[1])


def test_visualizer_grouping_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(ptb.time, "time", lambda: WALL)
    scalars = {"detection_loss": 1.0, "obj_acc": 0.5, "pos_ratio": 0.1, "lr_value": 2e-3,
               "misc": 7.0, "mAP_0.25": 0.03}
    for mod, d in ((jtb, tmp_path / "jax"), (ptb, tmp_path / "port")):
        v = mod.Visualizer(str(d), "train")
        v.log_scalars(scalars, step=1)
        v.log_scalars({"loss": 0.5}, step=2)
        v.close()
    grouped = {"loss/detection_loss": 1.0, "acc/obj_acc": 0.5, "ratio/pos_ratio": 0.1,
               "value/lr_value": 2e-3, "other/misc": 7.0, "other/mAP_0.25": 0.03}
    events = [(0, [], "brain.Event:2"),
              (1, [jtb._scalar_value(t, v) for t, v in grouped.items()], ""),
              (2, [jtb._scalar_value("loss/loss", 0.5)], "")]
    for wrap, d in ((False, "jax"), (True, "port")):
        assert open(_event_file(tmp_path / d / "tb" / "train"), "rb").read() == b"".join(
            _frame(_jax_event(s, v, f, wrap)) for s, v, f in events)


def _images():
    rng = np.random.RandomState(1)
    return [
        rng.randint(0, 256, (12, 8, 3)).astype(np.uint8),
        rng.randint(0, 256, (5, 7)).astype(np.uint8),  # grey: three equal channels
        rng.uniform(-40, 300, (6, 4, 3)),  # clipped to 0-255
        rng.randint(0, 256, (3, 9, 4)).astype(np.uint8),  # RGBA
        np.zeros((1, 1, 3), np.uint8),
    ]


def _image_values(path, wrapped):
    """[(tag, (height, width, colorspace), pixels)] of every image record;
    ``wrapped``: each Value framed as Summary.value (the port), else the
    JAX writer's bare Value fields, one Value a record."""
    from PIL import Image

    out = []
    for rec in _records(path)[1:]:
        summary = dict(_fields(rec))[5]
        values = [value for _, value in _fields(summary)] if wrapped else [summary]
        for value in values:
            v = dict(_fields(value))
            img = dict(_fields(v[4]))
            pixels = np.asarray(Image.open(io.BytesIO(img[4])))
            out.append((v[1], (img[1], img[2], img[3]), pixels))
    return out


def test_tb_images_decode_to_jax_pixels(tmp_path, monkeypatch):
    pytest.importorskip("PIL")  # the JAX writer's encoder and the test's decoder
    monkeypatch.setattr(ptb.time, "time", lambda: WALL)
    for mod, d in ((jtb, tmp_path / "jax"), (ptb, tmp_path / "port")):
        w = mod.TBWriter(str(d))
        # one image a record: the JAX writer's bare Values cannot be told apart
        for i, img in enumerate(_images()):
            w.image_summary(f"views{i}", [img], step=3 + i)
        w.close()
        v = mod.Visualizer(str(d), "train")
        v.log_images({"seeds": _images()[:1]}, step=1)
        v.close()
    for sub in ("", os.path.join("tb", "train")):
        got = _image_values(_event_file(tmp_path / "port" / sub), True)
        want = _image_values(_event_file(tmp_path / "jax" / sub), False)
        assert [g[:2] for g in got] == [w[:2] for w in want] and got
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[2], w[2])
    # several images in one record, each its own Value
    w = ptb.TBWriter(str(tmp_path / "many"))
    w.image_summary("views", _images(), step=9)
    w.close()
    got = _image_values(_event_file(tmp_path / "many"), True)
    assert [g[0] for g in got] == [f"views/{i}".encode() for i in range(5)]
    for g, img in zip(got, _images()):
        want = np.clip(img, 0, 255).astype(np.uint8)
        want = want[:, :, None].repeat(3, 2) if want.ndim == 2 else want
        np.testing.assert_array_equal(g[2], want)


def test_png_encoder_pixels():
    pytest.importorskip("PIL")
    from PIL import Image

    for img in _images()[:1] + _images()[3:]:
        got = np.asarray(Image.open(io.BytesIO(ptb.encode_png(img))))
        np.testing.assert_array_equal(got.reshape(img.shape), img)
    grey = np.arange(6, dtype=np.uint8).reshape(2, 3, 1)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(ptb.encode_png(grey)))),
                                  grey[..., 0])


def _writer_inputs(rng):
    return [
        ("write_ply", (rng.randn(20, 3),)),
        ("write_ply", (np.zeros((0, 3)),)),
        ("write_ply_rgb", (rng.randn(10, 3), rng.randint(0, 256, (10, 3)))),
        ("write_ply_color", (rng.randn(15, 3), rng.randint(0, 5, 15))),
        ("write_ply_color", (rng.randn(15, 3), rng.randint(0, 5, 15)), {"num_classes": 9}),
        ("write_oriented_bbox", (np.c_[rng.randn(4, 3), rng.uniform(0.2, 2, (4, 3)),
                                       rng.uniform(-3, 3, 4)],)),
        ("write_oriented_bbox", (np.zeros((0, 7)),)),
        ("write_bbox", (np.c_[rng.randn(3, 3), rng.uniform(0.2, 2, (3, 3))],)),
        ("write_oriented_bbox_camera_coord", (np.c_[rng.randn(2, 3), rng.uniform(0.2, 2, (2, 3)),
                                                    rng.uniform(-3, 3, 2)],)),
        ("write_lines_as_cylinders", (np.stack([rng.randn(3, 3), rng.randn(3, 3)], 1),)),
        ("write_lines_as_cylinders", (np.zeros((1, 2, 3)),), {"rad": 0.01, "res": 8}),
    ]


def test_ply_writers_byte_equal(tmp_path):
    for mod, d in ((jdump, tmp_path / "jax"), (pdump, tmp_path / "port")):
        d.mkdir()
        for i, (name, args, *kw) in enumerate(_writer_inputs(np.random.RandomState(2))):
            getattr(mod, name)(*args, str(d / f"{i:02d}_{name}.ply"), **(kw[0] if kw else {}))
    _same_files(tmp_path / "jax", tmp_path / "port")


def _dump_case(dataset, rng, b=2, k=6, n=50, g=4):
    cfg = get_config(dataset)
    nh = cfg.num_heading_bin
    ep = {
        "seed_xyz": rng.randn(b, 16, 3).astype(np.float32),
        "vote_xyz": rng.randn(b, 16, 3).astype(np.float32),
        "aggregated_vote_xyz": rng.randn(b, k, 3).astype(np.float32),
        "center": rng.randn(b, k, 3).astype(np.float32),
        "objectness_scores": rng.randn(b, k, 2).astype(np.float32) * 3,
        "size": (np.abs(rng.randn(b, k, 3)) + 0.1).astype(np.float32),
        "heading": rng.uniform(-3, 3, (b, k)).astype(np.float32) if nh > 1
        else np.zeros((b, k), np.float32),
    }
    batch = {
        "point_clouds": rng.randn(b, n, 4).astype(np.float32),
        "center_label": rng.randn(b, g, 3).astype(np.float32),
        "box_label_mask": (rng.rand(b, g) < 0.7).astype(np.float32),
        "size_class_label": rng.randint(0, cfg.num_size_cluster, (b, g)),
        "size_residual_label": rng.randn(b, g, 3).astype(np.float32) * 0.05,
        "heading_class_label": rng.randint(0, nh, (b, g)),
        "heading_residual_label": rng.randn(b, g).astype(np.float32) * 0.1,
        "scan_idx": np.array([7, 8]),
    }
    return ep, batch


@pytest.mark.parametrize("dataset", ["scannet", "sunrgbd"])
def test_dump_results_byte_equal(tmp_path, dataset):
    ep, batch = _dump_case(dataset, np.random.RandomState(3))
    jdump.dump_results(ep, batch, str(tmp_path / "jax"), jax_get_config(dataset))
    pdump.dump_results(ep, batch, str(tmp_path / "port"), get_config(dataset))
    # tensors, as evaluate passes them
    tensors = lambda d: {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}  # noqa: E731
    pdump.dump_results(tensors(ep), tensors(batch), str(tmp_path / "tensors"), get_config(dataset))
    pdump.dump_results(ep, batch, str(tmp_path / "inference"), get_config(dataset),
                       inference_switch=True)
    _same_files(tmp_path / "jax", tmp_path / "port")
    _same_files(tmp_path / "jax", tmp_path / "tensors")
    names = os.listdir(tmp_path / "port")
    assert "000007_gt_bbox.ply" in names and "000008_pc.ply" in names
    assert not any("gt_bbox" in n for n in os.listdir(tmp_path / "inference"))


def test_precision_recall_matches_jax():
    box = lambda c: np.array(list(c) + [1.0, 1.0, 1.0])  # noqa: E731
    gt = np.stack([box([0, 0, 0]), box([5, 5, 5])])
    pred = np.stack([np.append(box([0.1, 0, 0]), 0.9), np.append(box([9, 9, 9]), 0.9),
                     np.append(box([5, 5, 5]), 0.1)])
    for mod in (pmetrics, jmetrics):
        assert mod.single_scene_precision_recall(gt, pred, 0.25, 0.5) == (1, 1, 1)
        assert mod.precision_recall(1, 1, 1) == (0.5, 0.5)
        assert mod.multi_scene_precision_recall(
            gt[None], pred[None], 0.25, 0.5, np.ones((1, 2)), np.array([[1, 0, 1]]))[1] == 0
        assert mod.calc_iou(box([0, 0, 0]), box([0.5, 0, 0])) == 1 / 3
    rng = np.random.RandomState(4)
    for _ in range(5):
        labels = np.c_[rng.uniform(-2, 2, (3, 6, 3)), rng.uniform(0.3, 1.5, (3, 6, 3))]
        pred = np.c_[labels[:, :5] + rng.normal(0, 0.2, (3, 5, 6)), rng.rand(3, 5, 1)]
        lmask, pmask = (rng.rand(3, 6) < 0.8).astype(float), (rng.rand(3, 5) < 0.8).astype(float)
        for iou, conf in ((0.25, 0.3), (0.5, 0.0)):
            for masks in ((lmask, pmask), (lmask, None), (None, None)):
                assert (pmetrics.multi_scene_precision_recall(labels, pred, iou, conf, *masks)
                        == jmetrics.multi_scene_precision_recall(labels, pred, iou, conf, *masks))
        assert pmetrics.precision_recall(0, 0, 3) == jmetrics.precision_recall(0, 0, 3)


def test_viz_votes_obb_and_sem_cls_statistics(tmp_path):
    import iou3dmatch_tpu.data.scannet as jscannet
    import iou3dmatch_tpu.data.sunrgbd as jsunrgbd

    import iou3dmatch_tpu_torch.data.scannet as pscannet
    import iou3dmatch_tpu_torch.data.sunrgbd as psunrgbd

    rng = np.random.RandomState(5)
    pc = rng.randn(40, 4)
    votes = rng.randn(40, 9)
    vmask = (rng.rand(40) < 0.5).astype(np.int64)
    label = rng.randn(6, 3)
    mask = np.array([1, 0, 1, 1, 0, 1])
    acls, ares = rng.randint(0, 12, 6), rng.randn(6) * 0.1
    scls, sres = rng.randint(0, 10, 6), rng.randn(6, 3) * 0.05
    for pkg, d in (((jscannet, jsunrgbd), tmp_path / "jax"), ((pscannet, psunrgbd), tmp_path / "port")):
        scan, sun = pkg
        (d / "scannet").mkdir(parents=True)
        (d / "sunrgbd").mkdir()
        scan.viz_votes(pc, votes, vmask, name="_a", out_dir=str(d / "scannet"))
        scan.viz_obb(pc, label, mask, acls, ares, scls, sres, name="_a", out_dir=str(d / "scannet"))
        sun.viz_votes(pc, votes, vmask, out_dir=str(d / "sunrgbd"))
        sun.viz_obb(pc, label, mask, acls, ares, scls, sres, out_dir=str(d / "sunrgbd"))
    for sub in ("scannet", "sunrgbd"):
        _same_files(tmp_path / "jax" / sub, tmp_path / "port" / sub)
    assert len(os.listdir(tmp_path / "port" / "sunrgbd")) == 6

    root = write_sunrgbd_dump(tmp_path / "dump", seed=6, n_train=4, n=1200)
    data = str(root / "sunrgbd_pc_bbox_votes_50k_v1_train")
    want = jsunrgbd.get_sem_cls_statistics(
        jsunrgbd.SunrgbdDetectionVotesDataset(data, num_points=1000), max_scenes=3)
    got = psunrgbd.get_sem_cls_statistics(
        psunrgbd.SunrgbdDetectionVotesDataset(data, num_points=1000), max_scenes=3)
    assert got == want and sum(got.values()) > 0
