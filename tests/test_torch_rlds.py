"""The port's TF-free RLDS path against TensorFlow and the JAX package, on
the CPU (`rt1_tpu_torch/data/{codecs,tfrecord,tfds,convert_rlds,
rlds_pipeline}.py`, `data.loader="rlds_tf"`).

* TFRecord framing and `tf.train.Example` decoding against
  `tf.data.TFRecordDataset` + `tf.io.parse_single_example`, exactly, on
  shards TF writes; a flipped byte raises.
* PNG bit-exact against `tf.io.decode_png` (TF's encodings, every filter
  type, PIL's files); JPEG bit-exact against `tf.io.decode_jpeg`'s default
  (IFAST) on TF's 4:2:0 q95 / q75, PIL's 4:4:4 / 4:2:2 and a file with
  restart markers, and INTEGER_ACCURATE shown to differ.
* The TFDS reader: split slices across shards against numpy indexing,
  TFDS's read order against tf.data's interleave, dense steps against the
  fixture's source arrays (PNG) and TF's decode (JPEG).
* `convert_rlds` and `rlds_pipeline` against JAX's functions; the trainer's
  `rlds_tf` loader against JAX's.

The fixture `tests/fixtures/tfds_language_table/` (a TFDS directory in
Language-Table's layout, one copy with JPEG frames and one with PNG, and
TF's decoded pixels of some frames) is written by this file:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_rlds.py --write-fixture

Its frames are the port's board renderer upscaled to 360x640, its data
seeded; TensorFlow writes the records and encodes the frames.
"""

import hashlib
import io
import json
import os
import struct
import sys
import zlib

import numpy as np
import pytest
import torch

from rt1_tpu_torch.data import codecs, tfds, tfrecord

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "tfds_language_table")
EPISODE_LENGTHS = (6, 7, 8)
SHARDS = ((0, 1), (2,))  # episodes a shard
INSTRUCTIONS = ("push the red moon to the blue cube", "separate the blocks",
                "move the yellow pentagon to the top left corner")
TF_DECODED = (("jpeg", 0, 0), ("jpeg", 2, 7), ("png", 0, 0), ("png", 2, 7))
JPEG_QUALITY = 95


def _tf():
    return pytest.importorskip("tensorflow")


# ---------------------------------------------------------------- fixture

def fixture_episodes(seed=19):
    """The fixture's episodes as arrays: board frames at 180x320 upscaled
    to Language-Table's 360x640, RLDS step fields, a 512-int32 instruction."""
    from rt1_tpu_torch.envs import rendering

    rng = np.random.default_rng(seed)
    names = ("red_moon", "blue_cube", "green_star", "yellow_pentagon")
    out = []
    for e, t in enumerate(EPISODE_LENGTHS):
        start = {n: (rng.uniform([0.2, -0.25], [0.55, 0.25]), float(rng.uniform(0, 6.28)))
                 for n in names}
        eff0, eff1 = rng.uniform([0.2, -0.25], [0.55, 0.25], (2, 2))
        frames, effs = [], []
        for s in range(t):
            a = s / max(t - 1, 1)
            eff = (1 - a) * eff0 + a * eff1
            poses = dict(start)
            poses[names[e]] = (start[names[e]][0] + 0.05 * a, start[names[e]][1])
            frame = rendering.render_board(poses, eff, image_size=(180, 320))
            frames.append(rendering.resize_bilinear(frame, 360, 640))
            effs.append(eff)
        code = np.zeros(512, np.int32)
        text = INSTRUCTIONS[e].encode("utf-8")
        code[:len(text)] = np.frombuffer(text, np.uint8)
        effs = np.asarray(effs, np.float32)
        out.append({
            "action": rng.uniform(-0.03, 0.03, (t, 2)).astype(np.float32),
            "is_first": np.arange(t) == 0,
            "is_last": np.arange(t) == t - 1,
            "is_terminal": np.arange(t) == t - 1,
            "reward": (np.arange(t) == t - 1).astype(np.float32),
            "observation": {
                "rgb": np.stack(frames),
                "instruction": np.tile(code, (t, 1)),
                "effector_translation": effs,
                "effector_target_translation": effs + np.float32(0.01),
            },
        })
    return out


def _tensor(shape, dtype, cls="tensor_feature.Tensor"):
    return {"pythonClassName": f"tensorflow_datasets.core.features.{cls}",
            "tensor": {"shape": {"dimensions": [str(d) for d in shape]}, "dtype": dtype,
                       "encoding": "none"}}


def features_json(encoding, hw=(360, 640)):
    """Language-Table's feature tree as TFDS writes features.json."""
    fd = "tensorflow_datasets.core.features.features_dict.FeaturesDict"
    scalar = "scalar.Scalar"
    obs = {
        "effector_target_translation": _tensor([2], "float32"),
        "effector_translation": _tensor([2], "float32"),
        "instruction": _tensor([512], "int32"),
        "rgb": {"pythonClassName": "tensorflow_datasets.core.features.image_feature.Image",
                "image": {"shape": {"dimensions": [str(hw[0]), str(hw[1]), "3"]},
                          "dtype": "uint8", "encodingFormat": encoding}},
    }
    step = {
        "action": _tensor([2], "float32"),
        "is_first": _tensor([], "bool", scalar),
        "is_last": _tensor([], "bool", scalar),
        "is_terminal": _tensor([], "bool", scalar),
        "observation": {"pythonClassName": fd, "featuresDict": {"features": obs}},
        "reward": _tensor([], "float32", scalar),
    }
    return {"pythonClassName": fd, "featuresDict": {"features": {"steps": {
        "pythonClassName": "tensorflow_datasets.core.features.dataset_feature.Dataset",
        "sequence": {"feature": {"pythonClassName": fd, "featuresDict": {"features": step}},
                     "length": "-1"}}}}}


def _example(tf, ep, encode):
    """One episode as TFDS serializes it: the step leaves stacked and
    flattened under "/"-joined keys, images encoded a step."""
    def floats(v):
        return tf.train.Feature(float_list=tf.train.FloatList(value=np.ravel(v).tolist()))

    def ints(v):
        return tf.train.Feature(int64_list=tf.train.Int64List(
            value=np.ravel(v).astype(np.int64).tolist()))

    obs = ep["observation"]
    feature = {
        "steps/action": floats(ep["action"]),
        "steps/is_first": ints(ep["is_first"]),
        "steps/is_last": ints(ep["is_last"]),
        "steps/is_terminal": ints(ep["is_terminal"]),
        "steps/reward": floats(ep["reward"]),
        "steps/observation/effector_target_translation": floats(obs["effector_target_translation"]),
        "steps/observation/effector_translation": floats(obs["effector_translation"]),
        "steps/observation/instruction": ints(obs["instruction"]),
        "steps/observation/rgb": tf.train.Feature(bytes_list=tf.train.BytesList(
            value=[encode(f) for f in obs["rgb"]])),
    }
    return tf.train.Example(features=tf.train.Features(feature=feature)).SerializeToString()


def write_tfds_dir(tf, root, eps, encoding, shards=SHARDS, name="language_table"):
    """A TFDS directory of `eps` in `shards` (episode indices a shard),
    records written by TF's TFRecordWriter, frames encoded by TF."""
    os.makedirs(root, exist_ok=True)
    if encoding == "jpeg":
        def encode(f):
            return tf.io.encode_jpeg(f, quality=JPEG_QUALITY).numpy()
    else:
        def encode(f):
            return tf.io.encode_png(f).numpy()
    n = len(shards)
    for i, members in enumerate(shards):
        path = os.path.join(root, f"{name}-train.tfrecord-{i:05d}-of-{n:05d}")
        with tf.io.TFRecordWriter(path) as w:
            for e in members:
                w.write(_example(tf, eps[e], encode))
    hw = eps[0]["observation"]["rgb"].shape[1:3]
    with open(os.path.join(root, "features.json"), "w") as f:
        json.dump(features_json(encoding, hw), f, indent=4, sort_keys=True)
    info = {"name": name, "version": "0.0.1", "fileFormat": "tfrecord",
            "description": "Language-Table layout: seeded board frames (test fixture).",
            "splits": [{"name": "train", "filepathTemplate": tfds.DEFAULT_TEMPLATE,
                        "shardLengths": [str(len(m)) for m in shards]}]}
    with open(os.path.join(root, "dataset_info.json"), "w") as f:
        json.dump(info, f, indent=4, sort_keys=True)


def _tf_read(tf, path):
    """Every record of a TFRecord file parsed by TF: {key: values}."""
    out = []
    for rec in tf.data.TFRecordDataset(path):
        ex = tf.train.Example.FromString(rec.numpy())
        out.append({k: (list(f.bytes_list.value) if f.HasField("bytes_list") else
                        np.array(f.float_list.value, np.float32) if f.HasField("float_list")
                        else np.array(f.int64_list.value, np.int64))
                    for k, f in ex.features.feature.items()})
    return out


def write_fixture(root=FIXTURE):
    import tensorflow as tf

    eps = fixture_episodes()
    decoded = {}
    for encoding in ("jpeg", "png"):
        write_tfds_dir(tf, os.path.join(root, encoding), eps, encoding)
        d = tfds.TfdsDirectory(os.path.join(root, encoding))
        for enc, e, s in TF_DECODED:
            if enc != encoding:
                continue
            path, index = d.read_order("train")[e]
            raw = _tf_read(tf, path)[index]["steps/observation/rgb"][s]
            decoded[f"{enc}_{e}_{s}"] = tf.image.decode_image(raw, channels=3).numpy()
    np.savez_compressed(os.path.join(root, "tf_decoded.npz"), **decoded)
    # Every frame's TF decode, by its SHA-256, in TFDS's read order.
    digests = {}
    for encoding in ("jpeg", "png"):
        d = tfds.TfdsDirectory(os.path.join(root, encoding))
        digests[encoding] = [
            [hashlib.sha256(tf.image.decode_image(b, channels=3).numpy().tobytes()).hexdigest()
             for b in _tf_read(tf, path)[index]["steps/observation/rgb"]]
            for path, index in d.read_order("train")]
    with open(os.path.join(root, "tf_decoded_sha256.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)


# ---------------------------------------------------------- TFRecord, Example

def test_tfrecords_and_examples_equal_tf(tmp_path):
    tf = _tf()
    rng = np.random.default_rng(0)
    paths, written = [], []
    for shard in range(3):
        path = str(tmp_path / f"d-train.tfrecord-{shard:05d}-of-00003")
        with tf.io.TFRecordWriter(path) as w:
            for _ in range(2 + shard):
                t = int(rng.integers(1, 6))  # ragged episode lengths
                feature = {
                    "steps/action": tf.train.Feature(float_list=tf.train.FloatList(
                        value=rng.normal(size=2 * t).astype(np.float32))),
                    "steps/is_first": tf.train.Feature(int64_list=tf.train.Int64List(
                        value=[1] + [0] * (t - 1))),
                    "big": tf.train.Feature(int64_list=tf.train.Int64List(
                        value=[0, 1, -1, 127, 128, 300, 2 ** 40, -2 ** 63, 2 ** 63 - 1])),
                    "names": tf.train.Feature(bytes_list=tf.train.BytesList(
                        value=[b"", b"abc" * t, bytes(range(256))])),
                    "empty": tf.train.Feature(float_list=tf.train.FloatList(value=[])),
                }
                w.write(tf.train.Example(features=tf.train.Features(
                    feature=feature)).SerializeToString())
                written.append(feature)
        paths.append(path)
    got = [tfrecord.parse_example(r) for p in paths for r in tfrecord.read_records(p)]
    assert len(got) == len(written) == 2 + 3 + 4
    spec = {"steps/action": tf.io.VarLenFeature(tf.float32),
            "steps/is_first": tf.io.VarLenFeature(tf.int64),
            "big": tf.io.VarLenFeature(tf.int64), "names": tf.io.VarLenFeature(tf.string),
            "empty": tf.io.VarLenFeature(tf.float32)}
    ref = [tf.io.parse_single_example(r, spec) for p in paths for r in tf.data.TFRecordDataset(p)]
    raw = [x.numpy() for p in paths for x in tf.data.TFRecordDataset(p)]
    assert raw == [r for p in paths for r in tfrecord.read_records(p)]
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(spec)
        for key in spec:
            want = r[key].values.numpy()
            if key == "names":
                assert g[key] == list(want)
            else:
                assert g[key].dtype == want.dtype and np.array_equal(g[key], want), key


def _write_records(path, records):
    """TFRecord framing, written the way TF's `RecordWriter` writes it."""
    with open(path, "wb") as f:
        for data in records:
            length = struct.pack("<Q", len(data))
            f.write(length + struct.pack("<I", codecs.masked_crc32c(length)))
            f.write(data + struct.pack("<I", codecs.masked_crc32c(data)))


@pytest.mark.parametrize("where", ["length", "data", "crc", "truncated"])
def test_corrupt_record_raises(tmp_path, where):
    path = str(tmp_path / "r.tfrecord")
    _write_records(path, [b"first record", b"second"])
    blob = bytearray(open(path, "rb").read())
    if where == "truncated":
        blob = blob[:-3]
    else:
        blob[{"length": 2, "data": 14, "crc": 12 + 12}[where]] ^= 0x40
    open(path, "wb").write(bytes(blob))
    with pytest.raises(tfrecord.DataLossError):
        list(tfrecord.read_records(path))


def test_crc32c_frames_records_as_tf_reads_them(tmp_path):
    """The masked CRC32C of the reader is TF's: TF reads records framed
    with it, and the reader reads them back."""
    tf = _tf()
    path = str(tmp_path / "w.tfrecord")
    records = [b"", b"x" * 1000, bytes(range(256)) * 3]
    _write_records(path, records)
    assert [r.numpy() for r in tf.data.TFRecordDataset(path)] == records
    assert list(tfrecord.read_records(path)) == records


def test_varints_decode_vectorised():
    rng = np.random.default_rng(3)
    values = np.concatenate([rng.integers(-2 ** 63, 2 ** 63 - 1, 200, dtype=np.int64),
                             [0, 1, 127, 128, 16383, 16384, -1]])
    buf = bytearray()
    for v in values.view(np.uint64):
        v = int(v)
        while True:
            byte = v & 0x7F
            v >>= 7
            buf.append(byte | (0x80 if v else 0))
            if not v:
                break
    np.testing.assert_array_equal(tfrecord.decode_varints(bytes(buf)), values)


# ----------------------------------------------------------------- images

def _board(h=360, w=640, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) % 256], -1).astype(np.int64)
    img[h // 4:h // 2, w // 6:w // 2] = (205, 60, 50)
    return np.clip(img + rng.integers(-20, 20, img.shape), 0, 255).astype(np.uint8)


def _png(img, filters):
    """A PNG of `img` (h, w, c) with row y filtered by filters[y]."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int64)
    rows = []
    for y in range(h):
        cur = x[y]
        up = x[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        f = filters[y]
        if f == 4:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        else:
            pred = [np.zeros_like(cur), left, up, (left + up) // 2][f]
        rows.append(bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    colour = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)
    return (codecs.PNG_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_bit_exact_against_tf(channels):
    tf = _tf()
    from PIL import Image

    base = _board(48, 80, seed=channels)
    img = np.concatenate([base, base[..., :1]], -1)[..., :channels] if channels != 3 else base
    cases = [tf.io.encode_png(img).numpy()]
    for f in range(5):  # every filter type alone, then mixed row by row
        cases.append(_png(img, [f] * img.shape[0]))
    cases.append(_png(img, [y % 5 for y in range(img.shape[0])]))
    mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[channels]
    bio = io.BytesIO()
    Image.fromarray(img[..., 0] if channels == 1 else img, mode).save(bio, "PNG")
    cases.append(bio.getvalue())
    for data in cases:
        for want in {1: (0, 1, 3), 2: (0, 1, 3), 3: (0, 3), 4: (0, 3, 4)}[channels]:
            ref = tf.io.decode_png(data, channels=want).numpy()
            got = codecs.decode_png(data, want)
            assert got.dtype == np.uint8 and np.array_equal(got, ref), (channels, want)
        np.testing.assert_array_equal(codecs.decode_png(data), img)


def test_png_refusals():
    from PIL import Image

    img = _board(8, 8)
    for mode, match in (("P", "palette"), ("I;16", "bit depth")):
        bio = io.BytesIO()
        src = Image.fromarray(img).convert(mode) if mode != "I;16" else \
            Image.fromarray(img[..., 0].astype(np.uint16) * 257, "I;16")
        src.save(bio, "PNG")
        with pytest.raises(codecs.ImageDecodeError, match=match):
            codecs.decode_png(bio.getvalue())
    # Adam7: the interlace byte of IHDR set, its CRC redone.
    data = bytearray(_png(img, [0] * 8))
    data[28] = 1
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    with pytest.raises(codecs.ImageDecodeError, match="interlaced"):
        codecs.decode_png(bytes(data))
    bad = bytearray(_png(img, [0] * 8))
    bad[40] ^= 1
    with pytest.raises(codecs.ImageDecodeError, match="CRC"):
        codecs.decode_png(bytes(bad))


def _jpeg_cases(tf):
    from PIL import Image

    img = _board()
    cases = {"tf 4:2:0 q95": tf.io.encode_jpeg(img, quality=95).numpy(),
             "tf 4:2:0 q75": tf.io.encode_jpeg(img, quality=75).numpy(),
             "tf odd size": tf.io.encode_jpeg(img[:37, :53], quality=90).numpy(),
             "tf gray": tf.io.encode_jpeg(img[..., :1], quality=90).numpy()}
    for name, kwargs in (("pil 4:4:4", {"subsampling": 0}), ("pil 4:2:2", {"subsampling": 1}),
                         ("pil restart markers", {"subsampling": 2, "restart_marker_blocks": 5}),
                         ("pil 4:2:2 odd", {"subsampling": 1})):
        bio = io.BytesIO()
        src = img[:45, :61] if "odd" in name else img
        Image.fromarray(src).save(bio, "JPEG", quality=90, **kwargs)
        cases[name] = bio.getvalue()
    rst = cases["pil restart markers"]
    assert sum(rst.count(bytes([0xFF, 0xD0 + i])) for i in range(8)) > 100
    return cases


def test_jpeg_bit_exact_against_tf_default_ifast():
    tf = _tf()
    accurate_differs = 0
    for name, data in _jpeg_cases(tf).items():
        for channels in (0, 1, 3):
            ref = tf.io.decode_jpeg(data, channels=channels).numpy()
            got = codecs.decode_jpeg(data, channels)
            assert got.shape == ref.shape and np.array_equal(got, ref), (name, channels)
            accurate = tf.io.decode_jpeg(data, channels=channels,
                                         dct_method="INTEGER_ACCURATE").numpy()
            accurate_differs += not np.array_equal(accurate, ref)
        np.testing.assert_array_equal(codecs.decode_image(data, 3),
                                      tf.image.decode_image(data, channels=3).numpy())
    # INTEGER_ACCURATE (libjpeg's ISLOW, PIL's default) would fail the test
    # above on every case: IFAST stays pinned.
    assert accurate_differs == 3 * len(_jpeg_cases(tf))


def test_jpeg_refusals():
    from PIL import Image

    bio = io.BytesIO()
    Image.fromarray(_board(32, 32)).save(bio, "JPEG", progressive=True)
    with pytest.raises(codecs.ImageDecodeError, match="progressive"):
        codecs.decode_jpeg(bio.getvalue())
    with pytest.raises(codecs.ImageDecodeError, match="not a JPEG"):
        codecs.decode_jpeg(b"\x00\x01garbage")
    with pytest.raises(codecs.ImageDecodeError, match="not a JPEG or PNG"):
        codecs.decode_image(b"GIF89a....")


def test_fixture_frames_equal_tf_pixels_without_tf():
    """The card's machine holds the decoders to TF through the pixels TF
    decoded into the fixture; no TensorFlow is imported here."""
    with np.load(os.path.join(FIXTURE, "tf_decoded.npz")) as z:
        stored = {k: z[k] for k in z.files}
    assert len(stored) == len(TF_DECODED)
    for enc, e, s in TF_DECODED:
        d = tfds.TfdsDirectory(os.path.join(FIXTURE, enc))
        ep = list(d.episodes("train"))[e]
        frame = ep["steps"].dense()["observation"]["rgb"][s]
        np.testing.assert_array_equal(frame, stored[f"{enc}_{e}_{s}"], err_msg=f"{enc} {e} {s}")


def test_every_fixture_frame_decodes_to_tfs_digest_without_tf():
    with open(os.path.join(FIXTURE, "tf_decoded_sha256.json")) as f:
        digests = json.load(f)
    for enc in ("jpeg", "png"):
        d = tfds.TfdsDirectory(os.path.join(FIXTURE, enc))
        got = [[hashlib.sha256(codecs.decode_image(b, 3).tobytes()).hexdigest()
                for b in ex["steps/observation/rgb"]] for ex in d.examples("train")]
        assert got == digests[enc] and sum(map(len, got)) == sum(EPISODE_LENGTHS), enc


def test_committed_fixture_reads_back_as_tf_reads_it():
    tf = _tf()
    eps = fixture_episodes()
    for enc in ("jpeg", "png"):
        d = tfds.TfdsDirectory(os.path.join(FIXTURE, enc))
        ours = list(d.episodes("train"))
        assert [len(e["steps"]) for e in ours] == list(EPISODE_LENGTHS)
        theirs = [r for p in d.shard_paths("train") for r in _tf_read(tf, p)]
        for e, (got, ref, src) in enumerate(zip(ours, theirs, eps)):
            dense = got["steps"].dense()
            tf_frames = np.stack([tf.image.decode_image(b, channels=3).numpy()
                                  for b in ref["steps/observation/rgb"]])
            np.testing.assert_array_equal(dense["observation"]["rgb"], tf_frames)
            if enc == "png":
                np.testing.assert_array_equal(tf_frames, src["observation"]["rgb"])
            np.testing.assert_array_equal(dense["action"].ravel(), ref["steps/action"])
            np.testing.assert_array_equal(dense["observation"]["instruction"].ravel(),
                                          ref["steps/observation/instruction"])
    with np.load(os.path.join(FIXTURE, "tf_decoded.npz")) as z:
        for enc, e, s in TF_DECODED:
            d = tfds.TfdsDirectory(os.path.join(FIXTURE, enc))
            path, index = d.read_order("train")[e]
            raw = _tf_read(tf, path)[index]["steps/observation/rgb"][s]
            np.testing.assert_array_equal(z[f"{enc}_{e}_{s}"],
                                          tf.image.decode_image(raw, channels=3).numpy())


# ------------------------------------------------------------ TFDS reader

def test_fixture_dense_steps_equal_their_source():
    eps = fixture_episodes()
    d = tfds.TfdsDirectory(os.path.join(FIXTURE, "png"))
    assert d.shard_lengths("train") == [len(m) for m in SHARDS]
    for got, src in zip(d.episodes("train"), eps):
        dense = got["steps"].dense()
        for key in ("action", "is_first", "is_last", "is_terminal", "reward"):
            assert dense[key].dtype == src[key].dtype, key
            np.testing.assert_array_equal(dense[key], src[key], err_msg=key)
        for key, want in src["observation"].items():
            assert dense["observation"][key].dtype == want.dtype, key
            np.testing.assert_array_equal(dense["observation"][key], want, err_msg=key)
        steps = list(got["steps"].as_numpy_iterator())
        assert len(steps) == len(src["action"])
        np.testing.assert_array_equal(steps[1]["observation"]["rgb"], src["observation"]["rgb"][1])
        assert steps[0]["is_first"] and not steps[1]["is_first"]


def _tiny_eps(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = int(rng.integers(1, 4))
        code = np.zeros(512, np.int32)
        code[:3] = (ord("a"), ord("b"), ord("0") + i % 10)
        out.append({"action": rng.uniform(-1, 1, (t, 2)).astype(np.float32),
                    "is_first": np.arange(t) == 0, "is_last": np.arange(t) == t - 1,
                    "is_terminal": np.arange(t) == t - 1,
                    "reward": np.full(t, i, np.float32),
                    "observation": {
                        "rgb": rng.integers(0, 255, (t, 4, 6, 3), dtype=np.uint8),
                        "instruction": np.tile(code, (t, 1)),
                        "effector_translation": rng.normal(size=(t, 2)).astype(np.float32),
                        "effector_target_translation": np.zeros((t, 2), np.float32)}})
    return out


@pytest.mark.parametrize("split", ["train", "train[:7]", "train[7:30]", "train[-5:]",
                                   "train[21:]", "train[:7800]"])
def test_split_slices_across_shards(tmp_path, split):
    tf = _tf()
    eps = _tiny_eps(45)
    shards = (tuple(range(0, 20)), tuple(range(20, 23)), tuple(range(23, 45)))
    write_tfds_dir(tf, str(tmp_path), eps, "png", shards=shards)
    d = tfds.TfdsDirectory(str(tmp_path))
    got = [int(e["steps"].dense()["reward"][0]) for e in d.episodes(split)]
    spec = split[len("train"):].strip("[]")
    lo, hi = tfds._split_bounds(spec, 45) if spec else (0, 45)
    assert sorted(got) == list(range(45))[lo:hi]  # the set: plain indexing over the shards
    # The order: tf.data's interleave of the per-shard slices, 16 x 16.
    want_order = [int(r) for r in _tf_interleave_rewards(tf, d, split)]
    assert got == want_order
    with pytest.raises(ValueError, match="no data"):
        list(d.episodes("train[50:60]"))


def _tf_interleave_rewards(tf, d, split):
    """The episodes' rewards in the order TFDS reads the split: tf.data's
    interleave (cycle 16, block 16) of each shard's skip/take."""
    instructions = d.file_instructions(split)
    paths = tf.constant([p for p, _, _ in instructions])
    skips = tf.constant([s for _, s, _ in instructions], tf.int64)
    takes = tf.constant([t for _, _, t in instructions], tf.int64)
    ds = tf.data.Dataset.from_tensor_slices((paths, skips, takes)).interleave(
        lambda p, s, t: tf.data.TFRecordDataset(p).skip(s).take(t),
        cycle_length=tfds.INTERLEAVE_CYCLE, block_length=tfds.INTERLEAVE_BLOCK)
    spec = {"steps/reward": tf.io.VarLenFeature(tf.float32)}
    return [tf.io.parse_single_example(r, spec)["steps/reward"].values.numpy()[0] for r in ds]


def test_split_errors_and_formats(tmp_path):
    d = tfds.TfdsDirectory(os.path.join(FIXTURE, "jpeg"))
    assert d.num_examples("train") == 3
    with pytest.raises(ValueError, match="unknown split"):
        d.file_instructions("test")
    with pytest.raises(ValueError, match="no data"):
        d.file_instructions("train[7800:7900]")
    assert [take for _, _, take in d.file_instructions("train[:7800]")] == [2, 1]
    with pytest.raises(FileNotFoundError):
        tfds.TfdsDirectory(str(tmp_path))


# ---------------------------------------------------------- convert_rlds

class _StepStream:
    """A stand-in RLDS episode: `steps.as_numpy_iterator()`."""

    def __init__(self, steps):
        self._steps = steps

    def as_numpy_iterator(self):
        return iter(self._steps)


def test_episode_from_rlds_equals_jax():
    from rt1_tpu.data import convert_rlds as jax_convert
    from rt1_tpu.eval.embedding import get_embedder as jax_embedder
    from rt1_tpu_torch.data import convert_rlds
    from rt1_tpu_torch.eval.embedding import get_embedder

    d = tfds.TfdsDirectory(os.path.join(FIXTURE, "png"))
    for ep in d.episodes("train"):
        steps = list(ep["steps"].as_numpy_iterator())
        ours = convert_rlds.episode_from_rlds({"steps": _StepStream(steps)}, get_embedder("hash"))
        theirs = jax_convert.episode_from_rlds({"steps": _StepStream(steps)}, jax_embedder("hash"))
        assert sorted(ours) == sorted(theirs)
        for k in ours:
            assert ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k]), k
    assert convert_rlds.episode_from_rlds({"steps": _StepStream([])}, get_embedder("hash")) is None
    raw = np.zeros(64, np.int32)
    raw[:5] = np.frombuffer(b"hello", np.uint8)
    assert convert_rlds.decode_instruction_bytes(raw) == jax_convert.decode_instruction_bytes(raw)


def test_convert_writes_jax_files_and_quotas(tmp_path):
    from rt1_tpu.data import convert_rlds as jax_convert
    from rt1_tpu.eval.embedding import get_embedder as jax_embedder
    from rt1_tpu_torch.data import convert_rlds, episodes

    out = tmp_path / "npz"
    assert convert_rlds.main(["--dataset_dir", os.path.join(FIXTURE, "jpeg"), "--output_dir",
                              str(out), "--num_train", "1", "--num_val", "1",
                              "--num_test", "1"]) == 0
    d = tfds.TfdsDirectory(os.path.join(FIXTURE, "jpeg"))
    src = list(d.episodes("train[:3]"))
    for i, split in enumerate(("train", "val", "test")):
        assert sorted(os.listdir(out / split)) == ["episode_0.npz"]
        got = episodes.load_episode(str(out / split / "episode_0.npz"))
        want = jax_convert.episode_from_rlds(
            {"steps": _StepStream(list(src[i]["steps"].as_numpy_iterator()))},
            jax_embedder("hash"))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    manifest = episodes.read_manifest(str(out))
    assert manifest["embedder"] == "hash" and manifest["episodes"] == 3
    assert manifest["splits"] == {"train": 1, "val": 1, "test": 1}
    episodes.check_embedder_compatibility(str(out), "hash")
    with pytest.raises(ValueError, match="mismatch"):
        episodes.check_embedder_compatibility(str(out), "ngram")
    # The default quotas take what there is, in order: all three in train.
    out2 = tmp_path / "all"
    assert convert_rlds.convert(os.path.join(FIXTURE, "png"), str(out2)) == 3
    assert sorted(os.listdir(out2 / "train")) == [f"episode_{i}.npz" for i in range(3)]
    assert os.listdir(out2 / "val") == [] and os.listdir(out2 / "test") == []


# ---------------------------------------------------------- rlds_pipeline

def _episode(t, h=36, w=64, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return {"rgb": rng.integers(0, 255, (t, h, w, 3), dtype=np.uint8),
            "instruction": rng.normal(size=(t, d)).astype(np.float32),
            "action": rng.uniform(-0.1, 0.1, (t, 2)).astype(np.float32),
            "is_first": np.array([True] + [False] * (t - 1)),
            "is_terminal": np.array([False] * (t - 1) + [True])}


def _to_tf(tf, tree):
    return {k: _to_tf(tf, v) if isinstance(v, dict) else tf.constant(v) for k, v in tree.items()}


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def test_pad_episode_and_windows_exact():
    tf = _tf()
    from rt1_tpu.data import rlds_pipeline as J
    from rt1_tpu_torch.data import rlds_pipeline as P

    for t, window in ((5, 3), (1, 6), (7, 1)):
        ep = _episode(t, seed=t)
        for fn in ("pad_episode", "episode_windows"):
            ours = getattr(P, fn)(ep, window)
            theirs = _np({k: v.numpy() for k, v in getattr(J, fn)(_to_tf(tf, ep), window).items()})
            for k in ep:
                assert ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k])


@pytest.mark.parametrize("crop_factor", [0.95, None])
@pytest.mark.parametrize("image_dtype", ["uint8", "float32"])
def test_eval_window_to_sample_exact(crop_factor, image_dtype):
    tf = _tf()
    from rt1_tpu.data import rlds_pipeline as J
    from rt1_tpu_torch.data import rlds_pipeline as P

    win = {k: v[1] for k, v in P.episode_windows(_episode(4), 3).items()}
    for h, w in ((20, 30), (64, 128), (36, 64)):
        kw = dict(window=3, crop_factor=crop_factor, height=h, width=w, image_dtype=image_dtype)
        ours = P.window_to_sample(win, P.RldsPipelineConfig(**kw), False)
        theirs = _np(J.window_to_sample(_to_tf(tf, win), J.RldsPipelineConfig(**kw), False))
        for group in ("observations", "actions"):
            for k, want in theirs[group].items():
                got = ours[group][k]
                assert got.dtype == want.dtype and got.shape == want.shape, k
                if got.dtype == np.float32:
                    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=k)
                else:
                    np.testing.assert_array_equal(got, want, err_msg=k)


def test_training_crop_against_tf_crop_and_resize():
    tf = _tf()
    from rt1_tpu_torch.data import rlds_pipeline as P

    rgb = _episode(6, h=45, w=80)["rgb"]
    cfg = P.RldsPipelineConfig(crop_factor=0.9, height=24, width=40, image_dtype="float32")
    rng = np.random.default_rng(7)
    boxes = P.crop_boxes(len(rgb), 45, 80, cfg, True, rng)
    ch, cw = P.crop_size(45, 80, 0.9)
    assert all(b[2:] == (ch, cw) and 0 <= b[0] <= 45 - ch and 0 <= b[1] <= 80 - cw
               for b in boxes)
    assert len({b[:2] for b in boxes}) > 1  # drawn a frame
    got = P._augment_images(rgb, cfg, True, boxes=boxes)
    frames = tf.image.convert_image_dtype(tf.constant(rgb), tf.float32)
    want = np.stack([tf.image.resize(tf.image.crop_to_bounding_box(frames[i], *boxes[i]),
                                     (24, 40), method="bilinear").numpy()
                     for i in range(len(rgb))])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    many = P.crop_boxes(400, 45, 80, cfg, True, np.random.default_rng(0))
    tops = {b[0] for b in many}
    assert tops == set(range(0, 45 - ch + 1))  # every offset, the ends included


@pytest.mark.parametrize("adjust,factors", [
    ("adjust_brightness", (-0.1, 0.04, 0.1)), ("adjust_contrast", (0.8, 1.0, 1.2)),
    ("adjust_saturation", (0.8, 0.97, 1.2)), ("adjust_hue", (-0.02, 0.013, 0.02, -0.4))])
def test_photometric_adjusts_equal_tf(adjust, factors):
    tf = _tf()
    from rt1_tpu_torch.data import rlds_pipeline as P

    img = np.random.default_rng(1).uniform(0, 1, (33, 57, 3)).astype(np.float32)
    img[0, :5] = ((0.5, 0.5, 0.5), (0.2, 0.2, 0.7), (0.7, 0.7, 0.1), (0, 0, 0), (1, 0.2, 1))
    for f in factors:
        np.testing.assert_allclose(getattr(P, adjust)(img, f),
                                   getattr(tf.image, adjust)(img, f).numpy(),
                                   rtol=0, atol=1e-5, err_msg=f"{adjust} {f}")


def _eval_batches(tf, J, P, eps, **kw):
    theirs = list(J.windowed_rlds_dataset(J.make_episode_dataset_from_arrays(eps),
                                          J.RldsPipelineConfig(**kw), training=False)
                  .as_numpy_iterator())
    stream = P.windowed_rlds_dataset(P.make_episode_dataset_from_arrays(eps),
                                     P.RldsPipelineConfig(**kw), training=False)
    ours = list(stream)
    stream.close()
    return ours, theirs


@pytest.mark.parametrize("kw", [
    {}, {"filter_terminal_windows": True}, {"multistep": 2},
    {"num_devices": 2, "filter_terminal_windows": True}, {"multistep": 2, "num_devices": 1}])
def test_eval_stream_order_exact(kw):
    tf = _tf()
    from rt1_tpu.data import rlds_pipeline as J
    from rt1_tpu_torch.data import rlds_pipeline as P

    eps = [_episode(t, h=30, w=40, seed=t) for t in (5, 9, 4)]
    base = dict(window=3, crop_factor=0.95, height=16, width=24, batch_size=2)
    ours, theirs = _eval_batches(tf, J, P, eps, **base, **kw)
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        for group in ("observations", "actions"):
            for k in b[group]:
                assert a[group][k].shape == b[group][k].shape, k
                np.testing.assert_array_equal(a[group][k], b[group][k], err_msg=k)


def test_training_pass_holds_jaxs_windows(monkeypatch):
    tf = _tf()
    from rt1_tpu.data import rlds_pipeline as J
    from rt1_tpu_torch.data import rlds_pipeline as P

    eps = [_episode(t, h=12, w=16, seed=10 + t) for t in (5, 3, 6, 2, 4)]
    kw = dict(window=2, crop_factor=None, height=12, width=16, batch_size=1, repeat=False,
              shuffle_buffer=7, seed=3)

    def key(b):
        return (b["observations"]["image"].tobytes(), b["actions"]["action"].tobytes(),
                b["actions"]["terminate_episode"].tobytes(),
                b["observations"]["natural_language_embedding"].tobytes())

    theirs = [key(b) for b in J.windowed_rlds_dataset(
        J.make_episode_dataset_from_arrays(eps), J.RldsPipelineConfig(**kw),
        training=True).as_numpy_iterator()]
    stream = P.windowed_rlds_dataset(P.make_episode_dataset_from_arrays(eps),
                                     P.RldsPipelineConfig(**kw), training=True)
    ours = [key(b) for b in stream]
    stream.close()
    assert len(ours) == sum((5, 3, 6, 2, 4)) and sorted(ours) == sorted(theirs)
    # The stream does not depend on the map's thread count.
    monkeypatch.setattr(P, "MAP_THREADS", 1)
    again = P.windowed_rlds_dataset(P.make_episode_dataset_from_arrays(eps),
                                    P.RldsPipelineConfig(**kw), training=True)
    assert [key(b) for b in again] == ours


def test_training_stream_repeats_and_closes():
    from rt1_tpu_torch.data import rlds_pipeline as P

    eps = [_episode(3, h=10, w=12, seed=1)]
    cfg = P.RldsPipelineConfig(window=2, crop_factor=0.9, height=8, width=8, batch_size=2,
                               photometric=True, shuffle_buffer=4)
    stream = P.windowed_rlds_dataset(P.make_episode_dataset_from_arrays(eps), cfg)
    batches = [next(stream) for _ in range(5)]  # 3 windows a pass: repeats
    stream.close()
    assert stream._thread.is_alive() is False
    img = batches[0]["observations"]["image"]
    assert img.shape == (2, 2, 8, 8, 3) and img.dtype == np.uint8
    with pytest.raises(StopIteration):
        next(stream)


def test_table_embedder_and_episode_tensors_equal_jax():
    tf = _tf()
    from rt1_tpu.data import rlds_pipeline as J
    from rt1_tpu_torch.data import rlds_pipeline as P

    rng = np.random.default_rng(0)
    instructions = ["push the red moon to the blue cube", "separate the blocks"]
    table = rng.normal(size=(2, 8)).astype(np.float32)
    ours, theirs = P.TableEmbedder(instructions, table), J.InGraphTableEmbedder(instructions, table)
    raw = np.zeros(64, np.int32)
    raw[:len(instructions[1])] = np.frombuffer(instructions[1].encode(), np.uint8)
    text = P.decode_instruction_bytes_tf(raw)
    assert text == J.decode_instruction_bytes_tf(tf.constant(raw)).numpy()
    for s in (text, b"do a backflip", "push the red moon to the blue cube"):
        np.testing.assert_array_equal(ours(s), theirs(tf.constant(s)).numpy())
    dense = {"action": rng.uniform(-0.1, 0.1, (4, 2)).astype(np.float32),
             "is_first": np.array([True, False, False, False]),
             "is_terminal": np.array([False, False, False, True]),
             "observation": {"rgb": rng.integers(0, 255, (4, 6, 8, 3), dtype=np.uint8),
                             "instruction": np.tile(raw, (4, 1))}}
    got = P.rlds_episode_to_tensors(dense, ours)
    want = {k: v.numpy() for k, v in J.rlds_episode_to_tensors(_to_tf(tf, dense), theirs).items()}
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_create_rlds_datasets_over_the_fixture_equals_jax_graph():
    """The port's TFDS front-end against JAX's graph fed the same episodes
    (JAX's own front-end needs tensorflow_datasets): the eval splits exact."""
    tf = _tf()
    from rt1_tpu.data import rlds_pipeline as J
    from rt1_tpu.eval.embedding import get_embedder as jax_embedder
    from rt1_tpu_torch.data import rlds_pipeline as P

    kw = dict(window=3, crop_factor=0.95, height=32, width=56, batch_size=2, shuffle_buffer=4)
    splits = ("train[:2]", "train[2:]", "train[1:]")
    for enc in ("jpeg", "png"):
        streams = P.create_rlds_datasets(os.path.join(FIXTURE, enc), P.RldsPipelineConfig(**kw),
                                         splits=splits)
        first_train = next(streams[0])
        assert first_train["observations"]["image"].shape == (2, 3, 32, 56, 3)
        d = tfds.TfdsDirectory(os.path.join(FIXTURE, enc))
        host = jax_embedder("hash")

        def embed(text):
            return tf.numpy_function(lambda s: host(np.asarray(s).item().decode("utf-8")),
                                     [text], tf.float32)

        for split, stream in zip(splits[1:], streams[1:]):
            eps = [{k: v.numpy() for k, v in J.rlds_episode_to_tensors(
                _to_tf(tf, e["steps"].dense()), embed).items()} for e in d.episodes(split)]
            theirs = list(J.windowed_rlds_dataset(J.make_episode_dataset_from_arrays(eps),
                                                  J.RldsPipelineConfig(**kw), training=False)
                          .as_numpy_iterator())
            ours = list(stream)
            assert len(ours) == len(theirs) > 0
            for a, b in zip(ours, theirs):
                for group in ("observations", "actions"):
                    for k in b[group]:
                        np.testing.assert_array_equal(a[group][k], b[group][k], err_msg=k)
        for s in streams:
            s.close()


# ---------------------------------------------------------------- trainer

@pytest.fixture(scope="module")
def rlds_store(tmp_path_factory):
    from rt1_tpu_torch.data import convert_rlds

    root = tmp_path_factory.mktemp("rlds_store")
    convert_rlds.convert(os.path.join(FIXTURE, "png"), str(root), num_train=2, num_val=1,
                         num_test=0)
    return str(root)


def _configs(data_dir, **data):
    from rt1_tpu.train.configs import tiny as jax_tiny
    from rt1_tpu_torch.configs import get_config

    cfg, jcfg = get_config("tiny"), jax_tiny.get_config()
    for key, value in {"data_dir": data_dir, "loader": "rlds_tf", **data}.items():
        setattr(cfg.data, key, value)
        jcfg.data[key] = value
    return cfg, jcfg


def test_trainer_rlds_eval_batch_equals_jax(rlds_store):
    _tf()
    from rt1_tpu.train import train as jax_train
    from rt1_tpu_torch.train.train import dataset_batches

    cfg, jcfg = _configs(rlds_store)
    stream = dataset_batches(cfg, "val")
    assert stream.loader == "rlds_tf"
    ours = next(stream.batches)
    stream.batches.close()
    theirs = next(jax_train.dataset_batches(jcfg, "val"))
    for group in ("observations", "actions"):
        assert sorted(ours[group]) == sorted(theirs[group])
        for k in theirs[group]:
            assert ours[group][k].dtype == theirs[group][k].dtype, k
            np.testing.assert_array_equal(ours[group][k], theirs[group][k], err_msg=k)
    train = dataset_batches(cfg, "train")
    batch = next(train.batches)
    train.batches.close()
    assert batch["observations"]["image"].shape == (8, 3, 32, 56, 3)


@pytest.mark.parametrize("data,match", [
    ({"packed_cache": True}, "packed_cache=True is incompatible"),
    ({"clip_tokens": True}, "clip_tokens requires the windowed loaders")])
def test_trainer_rlds_refusals_are_jaxs(rlds_store, data, match):
    from rt1_tpu.train import train as jax_train
    from rt1_tpu_torch.train.train import dataset_batches

    cfg, jcfg = _configs(rlds_store, **data)
    with pytest.raises(ValueError, match=match) as ours:
        dataset_batches(cfg, "train")
    with pytest.raises(ValueError, match=match) as theirs:
        jax_train.dataset_batches(jcfg, "train")
    assert str(ours.value) == str(theirs.value)


def test_tiny_trains_three_steps_with_rlds_tf(rlds_store, tmp_path):
    from rt1_tpu_torch.train import __main__ as train_main

    workdir = str(tmp_path / "wd")
    args = ["--config", "tiny", "--workdir", workdir, "--device", "cpu",
            "--set", f"data.data_dir={rlds_store}", "--set", "data.loader=rlds_tf",
            "--set", "num_steps=3", "--set", "eval_every_steps=1",
            "--set", "checkpoint_every_steps=3"]
    assert train_main.main(args) in (0, None)
    lines = [json.loads(x) for x in open(os.path.join(workdir, "metrics.jsonl"))]
    # Three evals: the one-pass val stream is opened again for each.
    assert [x["step"] for x in lines if "eval_loss" in x] == [1, 2, 3]
    assert os.path.exists(os.path.join(workdir, "checkpoints", "3", "state.pt"))
    with open(os.path.join(workdir, "data_manifest.json")) as f:
        assert json.load(f)["source"] == "rlds"


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-fixture"]:
        write_fixture()
        sizes = {os.path.relpath(os.path.join(r, f), FIXTURE):
                 os.path.getsize(os.path.join(r, f))
                 for r, _, fs in os.walk(FIXTURE) for f in fs}
        print(json.dumps({"bytes": sum(sizes.values()), "files": sizes}, indent=1))
    else:
        raise SystemExit("usage: python tests/test_torch_rlds.py --write-fixture")
