"""The data pipeline of the port (data/dataset.py, data/image_io.py,
data/prefetch.py) against the JAX package's (data/dataset.py, which decodes
with PIL), on the same records, images and seeds.

Batches: the order, input_ids, labels, splice plans, sequence lengths and the
per-task masks are EXACT, and so are the tower pixels (test_torch_mm_utils.py's
`process_images` tolerance: arrays equal); the port's host-only raw images
equal PIL's RGB decode of each file. `modality_grouped_order` is exact. Also
`skip_batches` (no decode of a skipped batch), `num_workers` (same bytes, same
order), the process striding; the PNG reader against PIL's decode in every
colour type and all five scanline filters; a JPEG without PIL raises; the
prefetch iterator's order, errors and close.
"""

import json
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from visper_lm_tpu import config as jconfig
from visper_lm_tpu.data import dataset as jds

from visper_lm_tpu_torch import config as tconfig
from visper_lm_tpu_torch.data import dataset as tds
from visper_lm_tpu_torch.data import image_io
from visper_lm_tpu_torch.data.prefetch import PrefetchIterator

from test_data_pipeline import FakeTokenizer

N_RECORDS = 14
IMAGE_SHAPES = [(40, 50), (31, 77), (64, 64), (90, 20), (28, 28), (55, 41)]
PIL_MODES = ["RGB", "RGBA", "L", "LA", "P", "RGB"]


def _records(n):
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        words = " ".join(f"w{int(x)}" for x in rng.integers(0, 50, size=3 + 2 * (i % 5)))
        rec = {"conversations": [
            {"from": "human", "value": f"<image>\nquestion {i} {words}"},
            {"from": "gpt", "value": f"answer {i} {words} {words}"},
        ]}
        if i % 4 == 3:
            rec["conversations"][0]["value"] = f"question {i} {words}"
            rec["conversations"] += [{"from": "human", "value": f"more {words}"},
                                     {"from": "gpt", "value": f"yes {i}"}]
        else:
            rec["image"] = f"img{i % len(IMAGE_SHAPES)}.png"
        out.append(rec)
    return out


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(1)
    for i, ((h, w), mode) in enumerate(zip(IMAGE_SHAPES, PIL_MODES)):
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        im = Image.fromarray(arr)
        im = im.quantize(256) if mode == "P" else im.convert(mode)
        if i == len(IMAGE_SHAPES) - 1:
            image_io.write_png(str(root / f"img{i}.png"), arr)     # the port's own writer
        else:
            im.save(root / f"img{i}.png")
    records = _records(N_RECORDS)
    (root / "data.json").write_text(json.dumps(records))
    (root / "data.jsonl").write_text("\n".join(json.dumps(r) for r in records) + "\n")
    return root


def _datasets(data, *, aspect="square", group=False, distill=True, path="data.json"):
    kw = dict(data_path=str(data / path), image_folder=str(data), image_aspect_ratio=aspect,
              image_size=28, model_max_length=128, group_by_modality_length=group)
    tok = FakeTokenizer()
    j = jds.SupervisedDataset(jds.DataConfig(**kw), tok, jconfig.tiny_test_vlm(distill=distill))
    t = tds.SupervisedDataset(tds.DataConfig(**kw), tok, tconfig.tiny_test_vlm(distill=distill))
    return j, t


def _assert_batches_equal(tb, jb):
    assert len(tb) == len(jb)
    for b_t, b_j in zip(tb, jb):
        pil = b_j.pop("pil_images")
        raw = b_t.pop(tds.RAW_IMAGES)
        assert sorted(b_t) == sorted(b_j)
        for k in b_j:
            assert b_t[k].dtype == b_j[k].dtype, k
            np.testing.assert_array_equal(b_t[k], b_j[k], err_msg=k)
        for r, p in zip(raw, pil):
            assert (r is None) == (p is None)
            if r is not None:
                np.testing.assert_array_equal(r, np.asarray(p.convert("RGB")))


ITER_KW = dict(seq_buckets=(32, 64, 128), distill_tasks=("gen", "depth", "seg"))


@pytest.mark.parametrize("aspect,group,path", [
    ("square", False, "data.json"), ("pad", True, "data.json"), ("square", True, "data.jsonl"),
])
def test_batches_equal_jax(data, aspect, group, path):
    j, t = _datasets(data, aspect=aspect, group=group, path=path)
    assert len(t) == len(j) == N_RECORDS
    assert t.modality_lengths == j.modality_lengths
    for seed in (0, 5):
        jb = list(jds.BatchIterator(j, 3, seed=seed, **ITER_KW))
        tb = list(tds.BatchIterator(t, 3, seed=seed, **ITER_KW))
        assert len(tb) == N_RECORDS // 3
        _assert_batches_equal(tb, jb)


def test_no_distill_batches_and_a_partial_last_batch(data):
    j, t = _datasets(data, distill=False)
    kw = dict(seq_buckets=(64, 128), seed=2, drop_last=False)
    _assert_batches_equal(list(tds.BatchIterator(t, 4, **kw)), list(jds.BatchIterator(j, 4, **kw)))


@pytest.mark.parametrize("batch_size,seed", [(1, 0), (3, 1), (4, 7), (50, 3)])
def test_modality_grouped_order_equals_jax(batch_size, seed):
    lengths = [int(x) for x in np.random.default_rng(seed).integers(-40, 40, size=523)]
    got = tds.modality_grouped_order(lengths, batch_size, seed)
    assert got == jds.modality_grouped_order(lengths, batch_size, seed)
    assert sorted(got) == list(range(len(lengths)))


def test_skip_batches_skips_without_decoding(data, monkeypatch):
    j, t = _datasets(data, group=True)
    full = list(tds.BatchIterator(t, 3, seed=4, **ITER_KW))
    loads = []
    real = tds.load_image
    monkeypatch.setattr(tds, "load_image", lambda p: loads.append(p) or real(p))
    skipped = list(tds.BatchIterator(t, 3, seed=4, skip_batches=2, **ITER_KW))
    assert len(skipped) == len(full) - 2
    n_images = sum(im is not None for b in skipped for im in b[tds.RAW_IMAGES])
    assert len(loads) == n_images                   # the two skipped batches were not decoded
    _assert_batches_equal(skipped, list(jds.BatchIterator(j, 3, seed=4, skip_batches=2, **ITER_KW)))
    for a, b in zip(skipped, full[2:]):
        for k in a:
            if k != tds.RAW_IMAGES:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_workers_keep_the_order_and_the_bytes(data):
    j, t = _datasets(data, aspect="pad")
    inline = list(tds.BatchIterator(t, 3, seed=3, **ITER_KW))
    pooled = list(tds.BatchIterator(t, 3, seed=3, num_workers=3, **ITER_KW))
    _assert_batches_equal(pooled, list(jds.BatchIterator(j, 3, seed=3, num_workers=2, **ITER_KW)))
    for a, b in zip(inline, pooled):
        for k in a:
            if k != tds.RAW_IMAGES:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("index,count", [(0, 2), (1, 2), (2, 3)])
def test_process_striding_equals_jax(data, index, count):
    j, t = _datasets(data, group=True)
    kw = dict(ITER_KW, seed=1, process_index=index, process_count=count)
    tb = list(tds.BatchIterator(t, 2, **kw))
    assert all(b["text_ids"].shape[1] == 128 for b in tb)   # the top bucket on every process
    _assert_batches_equal(tb, list(jds.BatchIterator(j, 2, **kw)))
    with pytest.raises(ValueError):
        tds.BatchIterator(t, 2, process_index=count, process_count=count)


def test_read_jsonl_and_coco_probe_records(data, tmp_path):
    assert tds.read_jsonl(str(data / "data.jsonl")) == jds.read_jsonl(str(data / "data.jsonl"))
    coco = {"images": [{"id": i, "file_name": f"{i:012d}.jpg"} for i in range(5)],
            "annotations": [{"image_id": i % 5, "caption": f"c{i}"} for i in range(12)]}
    path = tmp_path / "captions.json"
    path.write_text(json.dumps(coco))
    got = tds.prepare_coco_probe_records(str(path))
    assert got == jds.prepare_coco_probe_records(str(path)) and len(got) == 5


# ---------------------------------------------------------------------------
# image files
# ---------------------------------------------------------------------------


def _png_with_filters(path, arr):
    """An RGB PNG whose rows cycle through the five scanline filters."""
    h, w, _ = arr.shape
    bpp, stride = 3, 3 * w
    raw = bytearray()
    prior = np.zeros(stride, np.int32)
    for y in range(h):
        kind = y % 5
        line = arr[y].reshape(-1).astype(np.int32)
        left = np.concatenate([np.zeros(bpp, np.int32), line[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(line)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        raw.append(kind)
        raw += ((line - pred) % 256).astype(np.uint8).tobytes()
        prior = line

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(image_io.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


def test_png_reader_equals_pil(data, tmp_path):
    for i in range(len(IMAGE_SHAPES)):
        path = str(data / f"img{i}.png")
        np.testing.assert_array_equal(image_io.load_image(path),
                                      np.asarray(Image.open(path).convert("RGB")), err_msg=path)
    rng = np.random.default_rng(7)
    smooth = (np.add.outer(np.arange(23), np.arange(37))[..., None] * [3, 5, 7]) % 256
    for k, arr in enumerate([rng.integers(0, 256, (23, 37, 3), dtype=np.uint8),
                             smooth.astype(np.uint8)]):
        path = str(tmp_path / f"filters{k}.png")
        _png_with_filters(path, arr)
        np.testing.assert_array_equal(np.asarray(Image.open(path).convert("RGB")), arr)
        np.testing.assert_array_equal(image_io.read_png(path), arr)
    bad = open(path, "rb").read().replace(b"IHDR" + struct.pack(">I", 37), b"IHDR" + struct.pack(">I", 38))
    (tmp_path / "bad.png").write_bytes(bad)                  # a width its scanlines do not have
    with pytest.raises(ValueError, match="scanlines"):
        image_io.read_png(str(tmp_path / "bad.png"))
    arr = rng.integers(0, 256, (9, 11, 3), dtype=np.uint8)
    np.save(tmp_path / "a.npy", arr)
    np.testing.assert_array_equal(image_io.load_image(str(tmp_path / "a.npy")), arr)
    np.save(tmp_path / "g.npy", arr[..., 0])
    np.testing.assert_array_equal(image_io.load_image(str(tmp_path / "g.npy")),
                                  np.repeat(arr[..., :1], 3, axis=-1))


def test_other_formats_need_pil(tmp_path, monkeypatch):
    arr = np.random.default_rng(3).integers(0, 256, (20, 30, 3), dtype=np.uint8)
    jpg, png16 = str(tmp_path / "a.jpg"), str(tmp_path / "b.png")
    Image.fromarray(arr).save(jpg)
    Image.fromarray((arr[..., 0].astype(np.uint16) * 257)).save(png16)
    np.testing.assert_array_equal(image_io.load_image(jpg), np.asarray(Image.open(jpg).convert("RGB")))
    assert image_io.read_png(png16) is None                 # 16-bit: PIL's
    np.testing.assert_array_equal(image_io.load_image(png16),
                                  np.asarray(Image.open(png16).convert("RGB")))
    monkeypatch.setitem(sys.modules, "PIL", None)
    for path in (jpg, png16):
        with pytest.raises(RuntimeError, match="needs PIL") as err:
            image_io.load_image(path)
        assert path in str(err.value)
    good = str(tmp_path / "c.png")
    image_io.write_png(good, arr)
    np.testing.assert_array_equal(image_io.load_image(good), arr)   # PNG needs no PIL


# ---------------------------------------------------------------------------
# prefetch
# ---------------------------------------------------------------------------


def test_prefetch_iterator_order_errors_and_close():
    cls = PrefetchIterator
    assert list(cls(range(100), depth=4)) == list(range(100))
    assert list(cls(iter([]), depth=1)) == []

    def boom():
        yield 1
        yield 2
        raise RuntimeError("decode failed")

    it = cls(boom(), depth=2)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)
    it = cls(range(10_000), depth=2)
    assert next(it) == 0
    it.close()
    with pytest.raises(StopIteration):
        next(it)
    with pytest.raises(ValueError):
        cls(range(3), depth=0)


@pytest.mark.parametrize("template,masked", [("llava_phi_3", True), ("vicuna_v1", True),
                                             ("llava_llama_3", False)])
def test_c14_multi_turn_records_under_the_whitespace_tokenizer(template, masked):
    """C14 (ROADMAP §C): with the whitespace test tokenizer a multi-turn record
    under the Phi3 or Vicuna template misses the template's round-length
    arithmetic (tuned to the real tokenizers), and the reference's rule then
    masks the whole record; JAX's preprocess and the port's give the same
    labels, all IGNORE_INDEX. Llama-3's template keeps the supervision."""
    from visper_lm_tpu.data.preprocess import preprocess as jpre
    from visper_lm_tpu_torch.constants import IGNORE_INDEX
    from visper_lm_tpu_torch.data.preprocess import preprocess as tpre

    turns = [{"from": "human", "value": "<image>\nwhat is here"}, {"from": "gpt", "value": "a cat on a mat"},
             {"from": "human", "value": "and its colour"}, {"from": "gpt", "value": "black and white"}]
    tok = FakeTokenizer()
    got = tpre([turns], tok, template, has_image=True)[0]
    ref = jpre([turns], tok, template, has_image=True)[0]
    assert got.input_ids == ref.input_ids and got.labels == ref.labels
    assert all(x == IGNORE_INDEX for x in got.labels) == masked
    single = tpre([turns[:2]], tok, template, has_image=True)[0]
    assert any(x != IGNORE_INDEX for x in single.labels)
