"""The port's ``data/pc_util.py`` and ``data/sunrgbd_calib.py`` against the
JAX package's, on the CPU, on the cases of tests/test_sunrgbd_calib.py.

Both sides are NumPy (and scipy, PIL, matplotlib) and run the same
operations, so arrays are compared bit for bit (dtype, shape and bytes);
functions that draw from a generator are given two generators of one seed
and must draw the same numbers. Files the functions write (PLY, JPEG, PNG
of a figure, pickles) are compared byte for byte, except matplotlib's PNG,
which carries no contract beyond being a PNG. Where PIL or matplotlib is
missing the port raises an ``ImportError`` that names the package.
"""
import sys

import numpy as np
import pytest

from iou3dmatch_tpu.data import pc_util as jpc
from iou3dmatch_tpu.data import sunrgbd_calib as jcal
from iou3dmatch_tpu_torch.data import pc_util as ppc
from iou3dmatch_tpu_torch.data import sunrgbd_calib as pcal


def same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert (got.dtype, got.shape) == (want.dtype, want.shape), (got.dtype, got.shape,
                                                                 want.dtype, want.shape)
    assert got.tobytes() == want.tobytes()


def write_calib(path, rtilt=None, K=None):
    """Rtilt and K written column-major, as the calib files hold them."""
    rtilt = np.eye(3) if rtilt is None else np.asarray(rtilt)
    K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]]) if K is None else K
    with open(path, "w") as f:
        f.write(" ".join(str(v) for v in rtilt.flatten(order="F")) + "\n")
        f.write(" ".join(str(v) for v in np.asarray(K).flatten(order="F")) + "\n")
    return path


def write_raw_scene(root, idx=1, lines=None):
    """A raw ``sunrgbd_trainval`` scene: image, calib, depth .mat and labels."""
    import scipy.io as sio
    from PIL import Image

    for d in ("image", "calib", "depth", "label", "label_v1"):
        (root / d).mkdir(exist_ok=True)
    Image.fromarray(np.random.RandomState(idx).randint(0, 255, (48, 64, 3), np.uint8)).save(
        root / "image" / f"{idx:06d}.jpg")
    write_calib(root / "calib" / f"{idx:06d}.txt", rtilt=jcal.rotx(0.1),
                K=np.array([[200.0, 0, 32], [0, 200.0, 24], [0, 0, 1]]))
    pts = np.random.RandomState(idx).uniform(-1, 1, (50, 6))
    pts[:, 1] += 3.0  # in front of the camera
    sio.savemat(root / "depth" / f"{idx:06d}.mat", {"instance": pts})
    lines = lines or ["bed 10 10 20 15 0.0 3.0 0.5 1.0 2.0 0.5 1 0",
                      "chair 5 6 7 8 0.5 2.5 0.3 0.3 0.4 0.45 0.7071 -0.7071",
                      "lamp 1 2 3 4 0.1 3.1 0.2 0.2 0.2 0.3 0 1"]
    for d in ("label", "label_v1"):
        (root / d / f"{idx:06d}.txt").write_text("\n".join(lines) + "\n")


# ------------------------------------------------------------------ pc_util
@pytest.mark.parametrize("t", [0.3, np.array([0.1, 0.2]), np.linspace(-3, 3, 12).reshape(3, 4)])
def test_rotations_match_jax(t):
    same(ppc.roty_batch(t), jpc.roty_batch(t))
    if np.ndim(t) == 0:
        same(ppc.rotz(t), jpc.rotz(t))
        same(ppc.roty(t), jpc.roty(t))
        same(pcal.rotx(t), jcal.rotx(t))


def test_rotate_point_cloud_matches_jax():
    pts = np.random.RandomState(0).randn(40, 3)
    got = ppc.rotate_point_cloud(pts.copy(), rng=np.random.RandomState(3))
    want = jpc.rotate_point_cloud(pts.copy(), rng=np.random.RandomState(3))
    same(got[0], want[0])
    same(got[1], want[1])
    mat = jcal.rotx(0.4)
    same(ppc.rotate_point_cloud(pts, mat)[0], jpc.rotate_point_cloud(pts, mat)[0])
    # the global stream when no generator is given
    np.random.seed(5)
    got = ppc.rotate_point_cloud(pts)[1]
    np.random.seed(5)
    same(got, jpc.rotate_point_cloud(pts)[1])


def test_rotate_pc_along_y_matches_jax_in_place():
    pc = np.random.RandomState(1).randn(30, 4)
    a, b = pc.copy(), pc.copy()
    out = ppc.rotate_pc_along_y(a, 0.7)
    assert out is a
    jpc.rotate_pc_along_y(b, 0.7)
    same(a, b)


def test_voxelization_matches_jax():
    pts = np.array([[0.0, 0.0, 0.0], [0.9, 0.9, 0.9], [-0.9, 0.0, 0.5]])
    rand = np.random.RandomState(2).uniform(-0.99, 0.99, (2, 300, 3))
    for cloud in (pts, rand[0]):
        same(ppc.point_cloud_to_volume(cloud, 8), jpc.point_cloud_to_volume(cloud, 8))
        vol = jpc.point_cloud_to_volume(cloud, 8, radius=1.0)
        same(ppc.volume_to_point_cloud(vol), jpc.volume_to_point_cloud(vol))
    same(ppc.volume_to_point_cloud(np.zeros((4, 4, 4))), jpc.volume_to_point_cloud(np.zeros((4, 4, 4))))
    for flatten in (True, False):
        same(ppc.point_cloud_to_volume_batch(rand, vsize=6, radius=1.0, flatten=flatten),
             jpc.point_cloud_to_volume_batch(rand, vsize=6, radius=1.0, flatten=flatten))


@pytest.mark.parametrize("n", [200, 2000])
def test_voxel_v2_and_image_match_jax(n):
    """Per-cell point sets: the cells sampled (more points than slots, the
    generator's draws) and the cells padded (fewer) both occur."""
    pts = np.random.RandomState(1).uniform(-0.99, 0.99, size=(n, 3))
    same(ppc.point_cloud_to_volume_v2(pts, vsize=4, num_sample=16, rng=np.random.RandomState(7)),
         jpc.point_cloud_to_volume_v2(pts, vsize=4, num_sample=16, rng=np.random.RandomState(7)))
    same(ppc.point_cloud_to_image(pts, imgsize=4, num_sample=16, rng=np.random.RandomState(8)),
         jpc.point_cloud_to_image(pts, imgsize=4, num_sample=16, rng=np.random.RandomState(8)))
    batch = np.stack([pts, pts[::-1]])
    same(ppc.point_cloud_to_volume_v2_batch(batch, vsize=3, num_sample=8,
                                            rng=np.random.RandomState(9)),
         jpc.point_cloud_to_volume_v2_batch(batch, vsize=3, num_sample=8,
                                            rng=np.random.RandomState(9)))
    same(ppc.point_cloud_to_image_batch(batch, imgsize=3, num_sample=8,
                                        rng=np.random.RandomState(10)),
         jpc.point_cloud_to_image_batch(batch, imgsize=3, num_sample=8,
                                        rng=np.random.RandomState(10)))


@pytest.mark.parametrize("n", [5, 16, 40])
def test_sample_or_pad_matches_jax(n):
    pc = np.random.RandomState(n).randn(n, 3)
    same(ppc._sample_or_pad(pc, 16, np.random.RandomState(0)),
         jpc._sample_or_pad(pc, 16, np.random.RandomState(0)))


def test_point_cloud_to_bbox_matches_jax():
    for pts in (np.array([[0, 0, 0], [2, 4, 6.0]]), np.random.RandomState(3).randn(2, 5, 3)):
        same(ppc.point_cloud_to_bbox(pts), jpc.point_cloud_to_bbox(pts))


def test_pyplot_draws_write_pngs(tmp_path):
    pts = np.random.RandomState(0).uniform(-0.9, 0.9, (50, 3))
    for mod in (ppc, jpc):
        f1, f2 = tmp_path / f"{mod.__name__}_pc.png", tmp_path / f"{mod.__name__}_vol.png"
        mod.pyplot_draw_point_cloud(pts, str(f1))
        mod.pyplot_draw_volume(mod.point_cloud_to_volume(pts, 8), str(f2))
        for f in (f1, f2):
            assert f.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_pyplot_draws_refuse_without_matplotlib(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match=r"data/pc_util\.py needs the package 'matplotlib'"):
        ppc.pyplot_draw_point_cloud(np.zeros((3, 3)), str(tmp_path / "x.png"))
    with pytest.raises(ImportError, match="matplotlib"):
        ppc.pyplot_draw_volume(np.zeros((2, 2, 2)))
    assert not (tmp_path / "x.png").exists()


# ------------------------------------------------------------ sunrgbd_calib
def test_rigid_transform_helpers_match_jax():
    R, t = jcal.rotx(0.3), np.array([1.0, -2.0, 0.5])
    same(pcal.transform_from_rot_trans(R, t), jcal.transform_from_rot_trans(R, t))
    T = jcal.transform_from_rot_trans(R, t)[0:3, :]
    same(pcal.inverse_rigid_trans(T), jcal.inverse_rigid_trans(T))


@pytest.mark.parametrize("line", [
    "chair 10 20 30 40 1.0 2.0 0.5 0.4 0.5 0.45 0.7071 -0.7071",
    "bed 10 10 20 15 0.0 3.0 0.5 1.0 2.0 0.5 1 0",
    "sofa 0 0 1 1 -1.5 4.0 0.2 0.9 0.4 0.35 -0.3 -0.95"])
def test_label_objects_and_boxes_match_jax(tmp_path, line):
    got, want = pcal.SUNObject3d(line), jcal.SUNObject3d(line)
    assert got.classname == want.classname
    for k in ("xmin", "ymin", "xmax", "ymax", "w", "l", "h", "heading_angle"):
        assert getattr(got, k) == getattr(want, k), k
    for k in ("box2d", "centroid", "unused_dimension", "orientation"):
        same(getattr(got, k), getattr(want, k))
    size = (want.l, want.w, want.h)
    same(pcal.my_compute_box_3d(want.centroid, size, want.heading_angle),
         jcal.my_compute_box_3d(want.centroid, size, want.heading_angle))

    calib_file = write_calib(tmp_path / "c.txt", rtilt=jcal.rotx(np.deg2rad(10.0)))
    pc_, jc_ = pcal.SUNRGBD_Calibration(calib_file), jcal.SUNRGBD_Calibration(calib_file)
    for a, b in zip(pcal.compute_box_3d(got, pc_), jcal.compute_box_3d(want, jc_)):
        same(a, b)
    for a, b in zip(pcal.compute_orientation_3d(got, pc_), jcal.compute_orientation_3d(want, jc_)):
        same(a, b)


def test_calibration_projections_match_jax(tmp_path):
    calib_file = write_calib(tmp_path / "c.txt", rtilt=jcal.rotx(np.deg2rad(10.0)))
    got, want = pcal.SUNRGBD_Calibration(calib_file), jcal.SUNRGBD_Calibration(calib_file)
    for k in ("Rtilt", "K", "f_u", "f_v", "c_u", "c_v"):
        same(getattr(got, k), getattr(want, k))
    pc = np.random.RandomState(0).randn(50, 3) * 0.5 + np.array([0.0, 3.0, 1.0])
    for name in ("project_upright_depth_to_camera", "project_upright_depth_to_upright_camera",
                 "project_upright_camera_to_upright_depth"):
        same(getattr(got, name)(pc), getattr(want, name)(pc))
    uv, d = want.project_upright_depth_to_image(pc)
    guv, gd = got.project_upright_depth_to_image(pc)
    same(guv, uv)
    same(gd, d)
    uvd = np.concatenate([uv, d[:, None]], axis=1)
    for name in ("project_image_to_camera", "project_image_to_upright_camerea",
                 "project_image_to_upright_camera"):
        same(getattr(got, name)(uvd), getattr(want, name)(uvd))


def test_in_hull_and_extract_match_jax():
    box = jcal.my_compute_box_3d((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), 0.3)
    pts = np.random.RandomState(4).uniform(-2, 2, (300, 4))
    same(pcal.in_hull(pts[:, :3], box), jcal.in_hull(pts[:, :3], box))
    for a, b in zip(pcal.extract_pc_in_box3d(pts, box), jcal.extract_pc_in_box3d(pts, box)):
        same(a, b)


def test_random_shift_box2d_matches_jax():
    box = np.array([10.0, 20.0, 50.0, 100.0])
    g, w = np.random.RandomState(3), np.random.RandomState(3)
    for ratio in (0.1, 0.3):
        for _ in range(10):
            same(pcal.random_shift_box2d(box, ratio, rng=g), jcal.random_shift_box2d(box, ratio, rng=w))


def test_draw_projected_box3d_matches_jax():
    qs = np.array([[10, 10], [40, 10], [40, 30], [10, 30],
                   [12, 14], [42, 14], [42, 34], [12, 34]])
    rotated = np.random.RandomState(0).uniform(-20, 100, (8, 2))  # edges leaving the image
    for corners in (qs, rotated):
        a, b = np.zeros((60, 80, 3), np.uint8), np.zeros((60, 80, 3), np.uint8)
        assert pcal.draw_projected_box3d(a, corners, color=(255, 0, 0)) is a
        jcal.draw_projected_box3d(b, corners, color=(255, 0, 0))
        same(a, b)
        assert a.any()


def test_zipped_pickles_cross_read(tmp_path):
    obj = {"a": np.arange(5), "b": "hi"}
    pcal.save_zipped_pickle(obj, tmp_path / "p.pkl.gz")
    jcal.save_zipped_pickle(obj, tmp_path / "j.pkl.gz")
    for f in ("p.pkl.gz", "j.pkl.gz"):
        for mod in (pcal, jcal):
            back = mod.load_zipped_pickle(tmp_path / f)
            assert back["b"] == "hi"
            same(back["a"], obj["a"])


def test_draw_boxes3d_in_point_cloud_matches_jax(tmp_path):
    boxes = np.stack([jcal.my_compute_box_3d(np.zeros(3), (1.0, 1.0, 1.0), 0.0),
                      jcal.my_compute_box_3d(np.ones(3), (0.3, 0.5, 0.2), 1.1)])
    pcal.draw_boxes3d_in_point_cloud(boxes, str(tmp_path / "p.ply"), rad=0.01)
    jcal.draw_boxes3d_in_point_cloud(boxes, str(tmp_path / "j.ply"), rad=0.01)
    assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


def test_sunrgbd_object_accessor_matches_jax(tmp_path):
    write_raw_scene(tmp_path)
    for use_v1 in (True, False):
        got, want = pcal.SunrgbdObject(str(tmp_path), use_v1=use_v1), \
            jcal.SunrgbdObject(str(tmp_path), use_v1=use_v1)
        assert len(got) == len(want) == 10335 and got.label_dir == want.label_dir
        same(got.get_image(1), want.get_image(1))
        same(got.get_depth(1), want.get_depth(1))
        same(got.get_calibration(1).K, want.get_calibration(1).K)
        assert [o.classname for o in got.get_label_objects(1)] == \
            [o.classname for o in want.get_label_objects(1)]
    assert pcal.sunrgbd_object is pcal.SunrgbdObject
    assert pcal.DEFAULT_TYPE_WHITELIST == jcal.DEFAULT_TYPE_WHITELIST
    np.savetxt(tmp_path / "pts.txt", np.arange(12.0).reshape(4, 3))
    same(pcal.load_depth_points(tmp_path / "pts.txt"), jcal.load_depth_points(tmp_path / "pts.txt"))
    same(pcal.load_depth_points_mat(tmp_path / "depth" / "000001.mat"),
         jcal.load_depth_points_mat(tmp_path / "depth" / "000001.mat"))


def test_get_box3d_dim_statistics_matches_jax(tmp_path):
    write_raw_scene(tmp_path, 1)
    write_raw_scene(tmp_path, 2, lines=["bed 1 1 2 2 0.0 3.0 0.5 1.2 2.2 0.4 0 1",
                                        "chair 1 1 2 2 0.5 2.5 0.3 0.35 0.45 0.5 1 0"])
    (tmp_path / "idx.txt").write_text("1\n2\n")
    got = pcal.get_box3d_dim_statistics(str(tmp_path / "idx.txt"), root_dir=str(tmp_path),
                                        save_path=str(tmp_path / "p.pkl"))
    want = jcal.get_box3d_dim_statistics(str(tmp_path / "idx.txt"), root_dir=str(tmp_path),
                                         save_path=str(tmp_path / "j.pkl"))
    assert sorted(got) == sorted(want) == ["bed", "chair"]
    for k in want:
        same(got[k], want[k])
    assert (tmp_path / "p.pkl").read_bytes() == (tmp_path / "j.pkl").read_bytes()


def test_data_viz_matches_jax(tmp_path):
    write_raw_scene(tmp_path)
    pcal.data_viz(str(tmp_path), dump_dir=str(tmp_path / "p"), idx=1)
    jcal.data_viz(str(tmp_path), dump_dir=str(tmp_path / "j"), idx=1)
    names = sorted(f.name for f in (tmp_path / "j").iterdir())
    assert names == ["img_boxes.jpg", "img_depth.jpg", "label_boxes.ply", "pc.ply"]
    assert sorted(f.name for f in (tmp_path / "p").iterdir()) == names
    for name in names:
        assert (tmp_path / "p" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name


def test_image_readers_refuse_without_pil(monkeypatch, tmp_path):
    write_raw_scene(tmp_path)
    monkeypatch.setitem(sys.modules, "PIL", None)
    msg = r"data/sunrgbd_calib\.py needs the package 'PIL'"
    with pytest.raises(ImportError, match=msg):
        pcal.load_image(str(tmp_path / "image" / "000001.jpg"))
    with pytest.raises(ImportError, match=msg):
        pcal.SunrgbdObject(str(tmp_path)).get_image(1)
    with pytest.raises(ImportError, match=msg):
        pcal.data_viz(str(tmp_path), dump_dir=str(tmp_path / "viz"), idx=1)
    assert not (tmp_path / "viz").exists()
    # what needs no image still works
    assert pcal.SunrgbdObject(str(tmp_path)).get_depth(1).shape == (50, 6)


@pytest.mark.parametrize("jax_module,port_module", [(jpc, ppc), (jcal, pcal)],
                         ids=["pc_util", "sunrgbd_calib"])
def test_every_jax_function_has_a_counterpart(jax_module, port_module):
    names = {n for n, v in vars(jax_module).items()
             if callable(v) and getattr(v, "__module__", None) == jax_module.__name__}
    assert names and not sorted(n for n in names if not callable(getattr(port_module, n, None)))
