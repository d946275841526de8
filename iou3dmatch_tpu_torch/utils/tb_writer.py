"""TensorBoard event files without TensorFlow.

The port's copy of ``iou3dmatch_tpu/utils/tb_writer.py``, which replaces the
reference's TF1 ``FileWriter`` wrapper (utils/tf_logger.py,
utils/tf_visualizer.py): Event and Summary protobufs encoded by hand and
framed as TFRecords (a length and a masked crc32c each), which TensorBoard
reads. Scalars, histograms and images (tf_logger.py:28-77).

Each Summary.Value is the JAX writer's byte for byte. The JAX writer puts a
Value's fields straight into the Summary, which TensorBoard cannot parse
(ROADMAP Queue 3); here each Value is a Summary's ``value`` field (1), as
TensorBoard's ``summary.proto`` defines it. Images are PNG, encoded here
with ``zlib`` (the JAX writer uses PIL, which the port does not need):
other bytes than PIL's, the same pixels.
"""
import os
import struct
import time
import zlib

import numpy as np

# ----------------------------------------------------------------- crc32c
_CRC_TABLE = []


def _build_table():
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        _CRC_TABLE.append(crc)


_build_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ------------------------------------------------------- protobuf encoding
def _varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b7 | 0x80])
        else:
            out += bytes([b7])
            return out


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", float(v))


def _int64(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _scalar_value(tag: str, value: float) -> bytes:
    # Summary.Value{ tag=1 (string), simple_value=2 (float) }
    return _len_delim(1, tag.encode()) + _float(2, value)


def _histo_value(tag: str, values: np.ndarray, bins: int = 30) -> bytes:
    values = np.asarray(values, dtype=np.float64).ravel()
    counts, edges = np.histogram(values, bins=bins)
    # HistogramProto: min=1 max=2 num=3 sum=4 sum_squares=5 (doubles),
    # bucket_limit=6, bucket=7 (packed repeated double)
    h = (
        _double(1, float(values.min())) + _double(2, float(values.max()))
        + _double(3, float(values.size)) + _double(4, float(values.sum()))
        + _double(5, float((values ** 2).sum()))
    )
    limits = struct.pack(f"<{bins}d", *edges[1:])
    buckets = struct.pack(f"<{bins}d", *counts.astype(np.float64))
    h += _len_delim(6, limits) + _len_delim(7, buckets)
    return _len_delim(1, tag.encode()) + _len_delim(5, h)


_PNG_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> grey, grey+alpha, RGB, RGBA


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def encode_png(arr: np.ndarray) -> bytes:
    """(H, W, C) uint8, C in 1-4 -> PNG bytes: 8 bits a channel, no
    interlace, every row with filter 0 (none), one zlib stream."""
    h, w, c = arr.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(arr).reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR_TYPE[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _png_chunk(b"IEND", b""))


def _image_value(tag: str, image: np.ndarray) -> bytes:
    """Summary.Value{ tag=1, image=4 } with a PNG of an HWC uint8 image
    (``tf_logger.image_summary``, utils/tf_logger.py:28-49); a 2-D image
    becomes three equal channels, as in the JAX writer."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None].repeat(3, axis=2)
    # Summary.Image: height=1 width=2 colorspace=3 (int32),
    # encoded_image_string=4 (bytes)
    img = (
        _tag(1, 0) + _varint(arr.shape[0])
        + _tag(2, 0) + _varint(arr.shape[1])
        + _tag(3, 0) + _varint(arr.shape[2])
        + _len_delim(4, encode_png(arr))
    )
    return _len_delim(1, tag.encode()) + _len_delim(4, img)


def _event(step: int, values=(), file_version: str = "") -> bytes:
    """Event{ wall_time=1 (double), step=2 (int64), file_version=3 |
    summary=5 }, the summary of the encoded Values ``values``."""
    ev = _double(1, time.time()) + _int64(2, step)
    if file_version:
        ev += _len_delim(3, file_version.encode())
    if values:
        # Summary{ repeated Value value=1 }
        ev += _len_delim(5, b"".join(_len_delim(1, v) for v in values))
    return ev


class TBWriter:
    """A minimal TensorBoard SummaryWriter: scalars, histograms, images."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.iou3dmatch"
        self._fh = open(os.path.join(log_dir, fname), "ab")
        self._write_record(_event(0, file_version="brain.Event:2"))

    def _write_record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._fh.write(header)
        self._fh.write(struct.pack("<I", _masked_crc(header)))
        self._fh.write(data)
        self._fh.write(struct.pack("<I", _masked_crc(data)))
        self._fh.flush()

    def scalar_summary(self, tag: str, value: float, step: int) -> None:
        self._write_record(_event(step, [_scalar_value(tag, value)]))

    def scalars(self, tag_value: dict, step: int) -> None:
        self._write_record(_event(step, [_scalar_value(t, v) for t, v in tag_value.items()]))

    def histo_summary(self, tag: str, values, step: int, bins: int = 30) -> None:
        self._write_record(_event(step, [_histo_value(tag, values, bins)]))

    def image_summary(self, tag: str, images, step: int) -> None:
        """images: HWC images; one Value an image, its tag suffixed with
        its index (tf_logger.py:28-49)."""
        self._write_record(_event(step, [_image_value(f"{tag}/{i}", img)
                                         for i, img in enumerate(images)]))

    def close(self) -> None:
        self._fh.close()


class Visualizer:
    """Scalars under loss/, acc/, ratio/, value/ and other/ by their names,
    as the reference's train.py:292-302 groups them
    (utils/tf_visualizer.py:15-48), into ``<log_dir>/tb/<name>``."""

    def __init__(self, log_dir: str, name: str = "train"):
        self.writer = TBWriter(os.path.join(log_dir, "tb", name))

    def log_scalars(self, scalar_dict: dict, step: int) -> None:
        grouped = {}
        for key, value in scalar_dict.items():
            if "loss" in key:
                prefix = "loss/"
            elif "acc" in key:
                prefix = "acc/"
            elif "ratio" in key:
                prefix = "ratio/"
            elif "value" in key:
                prefix = "value/"
            else:
                prefix = "other/"
            grouped[prefix + key] = float(value)
        self.writer.scalars(grouped, step)

    def log_images(self, visuals: dict, step: int) -> None:
        """visuals: {label: [HWC images]} (tf_visualizer.py:27-31)."""
        for label, images in visuals.items():
            self.writer.image_summary(label, images, step)

    def close(self) -> None:
        self.writer.close()
