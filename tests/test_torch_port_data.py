"""The port's data pipeline against the JAX package's, on the CPU.

PNG files go both ways between the port's codec and PIL; the synthetic
generator, the triptych decode, the split, the augmentation and the
loaders' batches are held against the JAX package's bit for bit. Where an
image is resized, the port's numpy INTER_LINEAR resize is held against
cv2, which the JAX package runs, within one uint8 level with the count of
unequal pixels printed (read: 0 at every size tested).
"""

import io
import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from image_enhancement_deglaring_tpu.data import augment as jax_augment
from image_enhancement_deglaring_tpu.data import dataset as jax_dataset
from image_enhancement_deglaring_tpu.data import pipeline as jax_pipeline
from image_enhancement_deglaring_tpu.data import synthetic as jax_synthetic
from image_enhancement_deglaring_tpu.utils import pytree as jax_pytree
from image_enhancement_deglaring_tpu_torch.data import (
    DevicePrefetcher,
    GlareRemovalDataset,
    decode_png,
    decode_triptych,
    encode_png,
    generate_synthetic_sd1,
    list_image_paths,
    make_dataloaders,
    make_triptych,
    optimized_augment,
    read_png,
    seeded_split,
    write_png,
)
from image_enhancement_deglaring_tpu_torch.data import png
from image_enhancement_deglaring_tpu_torch.data.augment import heavy_augment
from image_enhancement_deglaring_tpu_torch.data.dataset import sliced_batch_count
from image_enhancement_deglaring_tpu_torch.data.pipeline import _resize_uint8
from image_enhancement_deglaring_tpu_torch.train.checkpoint import (
    restore_checkpoint,
    restore_params,
    save_checkpoint,
)
from image_enhancement_deglaring_tpu_torch.utils import (
    ExperimentLogger,
    flatten_tree,
    load_npz_tree,
    set_seed,
    unflatten_tree,
)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
MODES = {"L": (), "LA": (2,), "RGB": (3,), "RGBA": (4,)}


def _image(mode: str, seed: int = 0, h: int = 23, w: int = 37) -> np.ndarray:
    """Seeded pixels: noise, a smooth ramp and flat runs, so that PIL's
    adaptive filtering picks every filter type somewhere."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (h, w) + MODES[mode], dtype=np.uint8)
    a[4:10] = (np.arange(w) * 7 % 256).astype(np.uint8).reshape((1, w) + (1,) * len(MODES[mode]))
    a[12:16] = 200
    return a


def _scanlines(data: bytes) -> np.ndarray:
    """The filtered scanlines of a PNG, filter byte first: (H, 1 + row bytes)."""
    ihdr, idat = None, b""
    for kind, body in png._chunks(data):
        ihdr = struct.unpack(">IIBBBBB", body) if kind == b"IHDR" else ihdr
        idat += body if kind == b"IDAT" else b""
    return np.frombuffer(zlib.decompress(idat), np.uint8).reshape(ihdr[1], -1)


def _filter_types(data: bytes) -> set[int]:
    return set(_scanlines(data)[:, 0].tolist())


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests run small tensors, several test processes at once: one
    intra-op thread each keeps torch's thread pools from oversubscribing
    the cores (the results here do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------- PNG


@pytest.mark.parametrize("mode", list(MODES))
def test_png_reads_what_pil_writes(mode):
    seen = set()
    for seed in range(3):
        a = _image(mode, seed)
        for optimize in (False, True):
            buf = io.BytesIO()
            Image.fromarray(a, mode).save(buf, "PNG", optimize=optimize)
            data = buf.getvalue()
            seen |= _filter_types(data)
            np.testing.assert_array_equal(decode_png(data), np.asarray(Image.open(buf)))
            np.testing.assert_array_equal(decode_png(data), a)
    print(f"{mode}: PIL wrote filter types {sorted(seen)}")
    assert len(seen) >= 2


def _average_image(h: int = 40, w: int = 64) -> np.ndarray:
    """Grayscale pixels that the average filter predicts exactly."""
    rng = np.random.default_rng(1)
    a = np.zeros((h, w), np.int64)
    a[0], a[:, 0] = rng.integers(0, 256, w), rng.integers(0, 256, h)
    for r in range(1, h):
        for c in range(1, w):
            a[r, c] = (a[r, c - 1] + a[r - 1, c]) >> 1
    return a.astype(np.uint8)


def test_png_reads_pil_files_with_every_filter_type():
    """PIL's adaptive filtering writes all five types over these images."""
    seen = set()
    images = [(_image(m, seed, h=40, w=64), m) for m in MODES for seed in range(4)]
    for a, mode in images + [(_average_image(), "L")]:
        for optimize in (False, True):
            buf = io.BytesIO()
            Image.fromarray(a, mode).save(buf, "PNG", optimize=optimize)
            seen |= _filter_types(buf.getvalue())
            np.testing.assert_array_equal(decode_png(buf.getvalue()), a)
    assert seen == set(png.FILTERS)


@pytest.mark.parametrize("filter_type", png.FILTERS)
@pytest.mark.parametrize("mode", list(MODES))
def test_pil_reads_what_png_writes(mode, filter_type):
    a = _image(mode, seed=filter_type)
    data = encode_png(a, filter_type=filter_type)
    assert _filter_types(data) == {filter_type}
    img = Image.open(io.BytesIO(data))
    assert img.mode == mode
    np.testing.assert_array_equal(np.asarray(img), a)
    np.testing.assert_array_equal(decode_png(data), a)


@pytest.mark.parametrize("mode", list(MODES))
def test_adaptive_filters_equal_pil_scanlines(mode):
    """``filter_type="adaptive"`` picks each row's filter as PIL's save
    does: the filtered scanlines equal PIL's byte for byte (noise, ramps,
    flat runs, and a smooth page that ties filters)."""
    images = [_image(mode, seed, h=40, w=64) for seed in range(3)]
    page = np.add.outer(np.arange(50), np.arange(70)).astype(np.uint8) * 2
    if MODES[mode]:
        page = np.repeat(page[..., None], MODES[mode][0], axis=-1)
    images.append(page)
    seen = set()
    for a in images:
        buf = io.BytesIO()
        Image.fromarray(a, mode).save(buf, "PNG")
        want = _scanlines(buf.getvalue())
        data = encode_png(a, filter_type="adaptive")
        np.testing.assert_array_equal(_scanlines(data), want)
        np.testing.assert_array_equal(decode_png(data), a)
        seen |= set(want[:, 0].tolist())
    assert {1, 2, 4} <= seen
    with pytest.raises(ValueError, match="adaptive"):
        encode_png(images[0], filter_type="paeth")


def _with_header(data: bytes, depth: int, colour: int, interlace: int) -> bytes:
    """``data`` with its IHDR's depth, colour type and interlace replaced."""
    w, h = struct.unpack(">II", data[16:24])
    body = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace)
    return data[:16] + body + struct.pack(">I", zlib.crc32(b"IHDR" + body)) + data[33:]


@pytest.mark.parametrize("name,header,match", [
    ("photo_palette_trns.png", (8, 5, 0), "colour type 5"),
    ("photo_16bit.png", (16, 3, 0), "bit depth 16 with colour type 3"),
    ("photo_1bit.png", (3, 0, 0), "bit depth 3"),
    ("photo_interlaced.png", (8, 0, 2), "interlace method 2"),
])
def test_png_refuses_what_it_does_not_decode(name, header, match):
    """Headers no PNG may have. The four fixtures themselves decode as PIL
    reads them (every mode is held in tests/test_torch_port_serve.py)."""
    path = os.path.join(FIXTURES, name)
    with open(path, "rb") as f:
        data = f.read()
    with pytest.raises(ValueError, match=match):
        decode_png(_with_header(data, *header))
    np.testing.assert_array_equal(read_png(path), np.asarray(Image.open(path)))


def test_png_refuses_corrupt_files(tmp_path):
    data = bytearray(encode_png(_image("L")))
    with pytest.raises(ValueError, match="signature"):
        decode_png(b"GIF89a" + bytes(data[6:]))
    data[40] ^= 0xFF  # inside the IDAT body: its CRC no longer holds
    with pytest.raises(ValueError, match="corrupt PNG chunk"):
        decode_png(bytes(data))
    with pytest.raises(ValueError, match="uint8"):
        encode_png(np.zeros((4, 4), np.float32))
    path = tmp_path / "a.png"
    write_png(path, _image("RGB"))
    np.testing.assert_array_equal(read_png(path), _image("RGB"))



def _png_of(ihdr: tuple, raw: bytes) -> bytes:
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", *ihdr))
            + chunk(b"IDAT", zlib.compress(raw, 9)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("interlace", [0, 1])
def test_png_inflates_no_more_than_the_image_as_pil(interlace):
    """A 3x2 gray image whose IDAT inflates to 64 MiB more than its
    scanlines: PIL stops at the image's end and so does the port, without
    inflating the rest."""
    img = _image("L")[:2, :3]
    passes = [(0, 0, 1, 1)] if not interlace else png._ADAM7
    lines = b"".join(b"\x00" + row.tobytes() for x0, y0, dx, dy in passes
                     for row in img[y0::dy, x0::dx] if row.size)
    data = _png_of((3, 2, 8, 0, 0, 0, interlace), lines + bytes(64 << 20))
    want = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(png.decode_png_image(data).pixels, want)
    np.testing.assert_array_equal(want, img)


@pytest.mark.parametrize("width,height", [(65535, 65535), (13377, 13378)])
def test_png_decompression_bomb_refused_as_pil_refuses(width, height):
    """An IHDR that claims more than twice PIL's MAX_IMAGE_PIXELS (13377 x
    13378 is just over it): PIL refuses it at open, the port before it
    inflates or allocates anything."""
    data = _png_of((width, height, 8, 0, 0, 0, 0), b"\x00\x07")
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(data))
    with pytest.raises(ValueError, match="decompression bomb"):
        decode_png(data)

# ---------------------------------------------------------- SD1 pipeline


def test_synthetic_data_equals_jax_package(tmp_path):
    for seed, size in ((0, 32), (5, 48)):
        a = make_triptych(np.random.default_rng(seed), size)
        b = jax_synthetic.make_triptych(np.random.default_rng(seed), size)
        np.testing.assert_array_equal(a, b)
        assert a.shape == (size, 3 * size, 4) and a.dtype == np.uint8
    port = generate_synthetic_sd1(str(tmp_path / "port"), n_train=3, n_val=2, size=32, seed=1)
    ref = jax_synthetic.generate_synthetic_sd1(str(tmp_path / "jax"), n_train=3, n_val=2,
                                               size=32, seed=1)
    for split in ("train", "val"):
        assert [os.path.basename(p) for p in port[split]] == \
            [os.path.basename(p) for p in ref[split]]
        for p, r in zip(port[split], ref[split]):
            np.testing.assert_array_equal(np.asarray(Image.open(p)), read_png(r))


@pytest.fixture(scope="module")
def sd1(tmp_path_factory):
    d = tmp_path_factory.mktemp("sd1")
    generate_synthetic_sd1(str(d), n_train=10, n_val=0, size=32, seed=3)
    return str(d / "train")


def test_decode_triptych_exact_at_no_resize(sd1):
    for path in list_image_paths(sd1)[:4]:
        got = decode_triptych(path, 32, with_mask=True)
        want = jax_pipeline.decode_triptych(path, 32, with_mask=True, use_native=False)
        for g, w in zip(got, want):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, w)
    # the native route at no resize: the JAX package's native numbers,
    # which equal the numpy path's there
    for path in list_image_paths(sd1)[:2]:
        got = decode_triptych(path, 32, use_native=True)
        want = jax_pipeline.decode_triptych(path, 32, use_native=True)
        for g, n, w in zip(got, decode_triptych(path, 32), want):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, n)
    with pytest.raises(RuntimeError, match="with_mask"):
        decode_triptych(list_image_paths(sd1)[0], 32, with_mask=True, use_native=True)


def test_decode_triptych_reads_a_jpeg_as_jax_does(sd1, tmp_path):
    """A triptych saved as JPEG (as users' own data may be): the pixels
    are PIL's, so at no resize the samples equal the JAX loader's."""
    from PIL import Image

    for i, path in enumerate(list_image_paths(sd1)[:2]):
        jpg = tmp_path / f"t{i}.jpg"
        with Image.open(path) as im:
            im.convert("RGB").save(jpg, quality=90, subsampling=2)
        got = decode_triptych(str(jpg), 32, with_mask=True)
        want = jax_pipeline.decode_triptych(str(jpg), 32, with_mask=True, use_native=False)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("size", [16, 24, 40, 64])
def test_decode_triptych_resized_within_one_level_of_cv2(sd1, size):
    unequal = 0
    for path in list_image_paths(sd1)[:3]:
        got = decode_triptych(path, size, with_mask=True)
        want = jax_pipeline.decode_triptych(path, size, with_mask=True, use_native=False)
        for g, w in zip(got, want):
            d = np.abs(np.rint(g * 255) - np.rint(w * 255))
            assert d.max() <= 1
            unequal += int((d > 0).sum())
    print(f"32 -> {size}: {unequal} pixels unequal to cv2's")


def test_resize_rule_matches_cv2_at_odd_ratios():
    import cv2

    rng = np.random.default_rng(7)
    for h, w, s in ((100, 100, 37), (37, 37, 100), (17, 17, 16), (64, 64, 48)):
        img = rng.integers(0, 256, (h, w), dtype=np.uint8)
        d = np.abs(_resize_uint8(img, s).astype(int) - cv2.resize(img, (s, s)).astype(int))
        print(f"{h}x{w} -> {s}: max {d.max()}, {(d > 0).sum()} unequal")
        assert d.max() <= 1


def test_split_and_listing_equal_jax_package(sd1):
    paths = list_image_paths(os.path.dirname(sd1))
    assert paths == jax_pipeline.list_image_paths(os.path.dirname(sd1))
    for val_split, seed in ((0.2, 42), (1 / 3, 0), (0.5, None)):
        if seed is None:
            continue  # unseeded splits draw from the global numpy stream
        assert seeded_split(paths, val_split, seed) == \
            jax_pipeline.seeded_split(paths, val_split, seed)


def test_optimized_augment_equals_jax_package():
    rng = np.random.default_rng(0)
    img = rng.random((16, 16)).astype(np.float32)
    tgt = rng.random((16, 16)).astype(np.float32)
    for seed in range(40):
        a = optimized_augment(img, tgt, np.random.default_rng(seed))
        b = jax_augment.optimized_augment(img, tgt, np.random.default_rng(seed))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for seed in range(40):  # the heavy stack too (tests/test_torch_port_augment.py: more)
        a = heavy_augment(img, tgt, np.random.default_rng(seed))
        b = jax_augment.heavy_augment(img, tgt, np.random.default_rng(seed))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("workers", [0, 2])
def test_loaders_yield_the_jax_batches_for_two_epochs(sd1, workers):
    kw = dict(batch_size=3, val_split=0.3, seed=42, image_size=32, num_workers=workers,
              augment="optimized")
    pt, pv = make_dataloaders(sd1, **kw)
    jt, jv = jax_dataset.make_dataloaders(sd1, **kw)
    assert (len(pt), len(pv)) == (len(jt), len(jv)) == (2, 1)
    for epoch in range(2):
        pt.set_epoch(epoch)
        jt.set_epoch(epoch)
        for loaders in ((pt, jt), (pv, jv)):
            got, want = list(loaders[0]), list(loaders[1])
            assert len(got) == len(want)
            for (gx, gy), (wx, wy) in zip(got, want):
                np.testing.assert_array_equal(gx, wx)
                np.testing.assert_array_equal(gy, wy)
    pt.set_skip_batches(1)
    jt.set_skip_batches(1)
    assert len(pt) == len(jt) == 1
    np.testing.assert_array_equal(next(iter(pt))[0], next(iter(jt))[0])


def test_loader_contracts(sd1):
    with pytest.raises(ValueError, match="zero steps"):
        make_dataloaders(sd1, batch_size=9, val_split=0.2, image_size=32)
    with pytest.raises(ValueError, match="No images"):
        make_dataloaders(os.path.join(sd1, "missing"))
    for args in ((10, 3, 2, True), (10, 3, 4, False), (7, 4, 2, False), (2, 3, 4, False)):
        assert sliced_batch_count(*args) == jax_dataset.sliced_batch_count(*args)
    ds = GlareRemovalDataset(list_image_paths(sd1), image_size=32, cache_images=True,
                             num_workers=2)
    x, y = ds[0]
    assert x.shape == y.shape == (32, 32, 1) and x.dtype == np.float32
    np.testing.assert_array_equal(x, jax_dataset.GlareRemovalDataset(
        list_image_paths(sd1), image_size=32, cache_images=True)[0][0])
    with pytest.raises(ValueError, match="augment"):
        GlareRemovalDataset([], augment="device")


def test_prefetcher_yields_tensors_input_cast_on_the_host(sd1):
    loader, _ = make_dataloaders(sd1, batch_size=4, image_size=32, num_workers=0)
    batches = list(DevicePrefetcher(loader, device="cpu", prefetch=0,
                                    input_dtype=torch.bfloat16))
    assert len(batches) == len(loader) == 2
    for (x, y), (wx, wy) in zip(batches, loader):
        assert x.dtype == torch.bfloat16 and y.dtype == torch.float32
        assert torch.equal(x, torch.from_numpy(wx).to(torch.bfloat16))
        assert torch.equal(y, torch.from_numpy(wy))

    class Broken:
        def __len__(self):
            return 2

        def __iter__(self):
            yield np.zeros((1, 2)), np.zeros((1, 2))
            raise OSError("decode failed")

    with pytest.raises(OSError, match="decode failed"):
        list(DevicePrefetcher(Broken(), device="cpu"))


# --------------------------------------------------------- utils, checkpoint


def test_pytree_names_equal_jax_package(tmp_path):
    tree = {"enc1": {"conv1": np.ones((3, 3, 1, 8), np.float32), "gn1_bias": np.zeros(8)},
            "output_conv_bias": np.ones(1)}
    assert flatten_tree(tree).keys() == jax_pytree.flatten_tree(tree).keys()
    flat = flatten_tree(tree)
    np.savez(tmp_path / "w.npz", **flat)
    back = load_npz_tree(str(tmp_path / "w.npz"))
    assert flatten_tree(back).keys() == flat.keys()
    assert unflatten_tree(flat)["enc1"]["conv1"] is flat["enc1/conv1"]


def test_checkpoint_round_trip(tmp_path):
    params = {"enc1": {"conv1": np.arange(6, dtype=np.float32).reshape(1, 1, 2, 3)},
              "output_conv_bias": np.ones(1, np.float32)}
    opt = {"count": np.asarray(3, np.int32), "inner_state/1/0/mu/enc1/conv1": np.ones(6)}
    path = save_checkpoint(str(tmp_path / "ck"), params=params, opt_state=opt, epoch=4,
                           val_loss=0.25, extra={"step": 3})
    save_checkpoint(path, params=params, opt_state=opt, epoch=5, val_loss=0.2)  # replaces
    item, meta = restore_checkpoint(path)
    assert meta == {"epoch": 5, "val_loss": 0.2, "model_arch": "lightweight"}
    np.testing.assert_array_equal(item["params"]["enc1"]["conv1"], params["enc1"]["conv1"])
    assert item["opt_state"].keys() == opt.keys()
    assert restore_params(path).keys() == params.keys()
    assert [p for p in os.listdir(tmp_path) if p.startswith(".ckpt-")] == []


def test_experiment_logger_writes_metrics_images_histograms(tmp_path):
    log = ExperimentLogger(str(tmp_path / "logs"), config={"lr": 1e-3, "bad": float("nan")})
    log.log({"train_loss": 0.5, "val_loss": float("inf")}, step=1)
    log.log_images("val", {"pred": np.linspace(0, 1, 64, dtype=np.float32).reshape(8, 8)},
                   step=1)
    log.log_histograms({"enc1": {"conv1": np.arange(10.0)}}, step=2, prefix="params")
    log.set_summary(best_epoch=1)
    log.save(str(tmp_path))
    log.finish()
    recs = [json.loads(line) for line in open(tmp_path / "logs" / "metrics.jsonl")]
    assert recs[0]["train_loss"] == 0.5 and recs[0]["val_loss"] is None
    assert recs[1]["_histograms_params"]["params/enc1/conv1"]["max"] == 9.0
    img = np.asarray(Image.open(tmp_path / "logs" / "images" / "step_000001" / "val_pred.png"))
    assert img.shape == (8, 8) and img[-1, -1] == 255
    assert json.load(open(tmp_path / "logs" / "config.json"))["bad"] is None
    assert log.summary == {"best_epoch": 1}


def test_set_seed_seeds_every_generator():
    g = set_seed(11, verbose=False)
    a = (np.random.rand(), torch.rand(1).item(), torch.rand(1, generator=g).item())
    g = set_seed(11, verbose=False)
    assert a == (np.random.rand(), torch.rand(1).item(), torch.rand(1, generator=g).item())
