"""The port's cv2-free JPEG decoder, JPEG encoder and resize
(`utils/imageio`) against cv2, on the CPU.

`decode_jpeg` must equal `cv2.imdecode` under `np.array_equal`, colour and
gray, on every frame of the committed ScanNet-layout fixture and on a grid
of files `cv2.imencode` writes here (qualities, chroma samplings, gray
input, restart intervals, sizes that are not multiples of the MCU), and on
the fixture's frames re-coded as one scan a component (single-component
scans, with and without restart markers). The kinds it does not read must
raise. `encode_jpeg` must give `cv2.imencode(".jpg", ...)`'s bytes, colour
and gray, on seeded noise and on rendered frames at 1x1, 7x9, 17x33,
240x320 and 608x800 (quality 95, cv2's default) and over a grid of
qualities; `decode_jpeg` of its bytes equals `cv2.imdecode` of cv2's,
and `write_jpeg` writes what `cv2.imwrite` writes. `resize` must equal
`cv2.resize` on uint8; float32 is within 1e-6 of the image's largest
magnitude (cv2's float path weighs in more than float32 precision, the
port in float64)."""

import struct

import cv2
import numpy as np
import pytest

from accelerated_features_tpu_torch.utils import imageio
from accelerated_features_tpu_torch.utils.imageio import (decode_jpeg,
                                                          imread,
                                                          imread_gray,
                                                          read_jpeg,
                                                          read_png, resize)

from torch_support import HOLDOUT, SCANNET_MINI

FRAMES = sorted(SCANNET_MINI.rglob("*.jpg"))
HOLDOUT_PNG = sorted(HOLDOUT.rglob("*.png"))[3]

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}
SIZES = [(1, 1), (9, 17), (179, 241), (480, 640)]


def _same_as_cv2(data: bytes):
    buf = np.frombuffer(data, np.uint8)
    for gray in (False, True):
        ref = cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE if gray
                           else cv2.IMREAD_COLOR)
        got = decode_jpeg(data, gray)
        assert got.dtype == np.uint8 and got.shape == ref.shape
        assert np.array_equal(got, ref), \
            f"gray={gray}: {(got != ref).sum()} pixels differ"


def _image(h, w, gray=False):
    """A crop (or cv2 resize) of a holdout frame: photographic content."""
    im = read_png(HOLDOUT_PNG)
    im = np.ascontiguousarray(im[:h, :w]) if h <= im.shape[0] \
        and w <= im.shape[1] else cv2.resize(im, (w, h))
    return cv2.cvtColor(im, cv2.COLOR_BGR2GRAY) if gray else im


def test_fixture_frames_are_640x480_baseline_420():
    assert len(FRAMES) == 6
    for path in FRAMES:
        data = path.read_bytes()
        i = data.index(b"\xff\xc0")
        _, _, h, w, n = struct.unpack(">HBHHB", data[i + 2:i + 10])
        assert (h, w, n) == (480, 640, 3)
        assert data[i + 11] == 0x22   # Y sampled 2x2: 4:2:0


@pytest.mark.parametrize("path", FRAMES,
                         ids=lambda p: str(p.relative_to(SCANNET_MINI)))
def test_decode_equals_cv2_on_the_fixture(path):
    _same_as_cv2(path.read_bytes())
    assert np.array_equal(read_jpeg(path), cv2.imread(str(path)))
    assert np.array_equal(imread(path), cv2.imread(str(path)))
    assert np.array_equal(imread_gray(path),
                          cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("quality", [30, 75, 95, 100])
def test_decode_equals_cv2_on_encoded_grid(size, sampling, quality):
    im = _image(*size)
    ok, buf = cv2.imencode(".jpg", im, [
        cv2.IMWRITE_JPEG_QUALITY, quality,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]])
    assert ok
    _same_as_cv2(buf.tobytes())


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("restart", [0, 1, 5])
@pytest.mark.parametrize("gray", [False, True], ids=["color", "gray"])
def test_decode_equals_cv2_with_restarts_and_gray_input(size, restart,
                                                        gray):
    """Restart markers every `restart` MCU rows' worth of MCUs (cv2's
    interval is in MCUs), and one-component (gray) files."""
    ok, buf = cv2.imencode(".jpg", _image(*size, gray=gray), [
        cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_RST_INTERVAL,
        restart])
    assert ok
    data = buf.tobytes()
    assert (b"\xff\xdd" in data) == (restart > 0)
    _same_as_cv2(data)


# -- single-component scans: re-code a file one scan a component ----------

def _huffman_codes(bits, vals):
    """{symbol: (code, length)} of a DHT table (T.81 C.2)."""
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(int(bits[length - 1])):
            codes[int(vals[k])] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


class _BitWriter:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value, length):
        self.acc = (self.acc << length) | (value & ((1 << length) - 1))
        self.n += length
        while self.n >= 8:
            byte = (self.acc >> (self.n - 8)) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)   # byte stuffing
            self.n -= 8

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)  # pad with ones


def _category(v):
    return 0 if v == 0 else int(abs(v)).bit_length()


def _code_block(w, block, pred, dc, ac):
    zz = block[imageio._NATURAL]
    diff = int(zz[0]) - pred
    s = _category(diff)
    w.put(*dc[s])
    if s:
        w.put(diff if diff > 0 else diff - 1, s)
    run = 0
    for k in range(1, 64):
        v = int(zz[k])
        if v == 0:
            run += 1
            continue
        while run > 15:
            w.put(*ac[0xF0])
            run -= 16
        s = _category(v)
        w.put(*ac[(run << 4) | s])
        w.put(v if v > 0 else v - 1, s)
        run = 0
    if run:
        w.put(*ac[0x00])
    return int(zz[0])


def _recode_one_scan_per_component(data: bytes, restart: int) -> bytes:
    """The same image (same coefficients, tables and frame) as a file with
    one scan for each component, each over the component's own blocks, and
    a restart marker every `restart` blocks."""
    frame = imageio._decode_coefficients(data)
    head, pos, tables, sos = bytearray(b"\xff\xd8"), 2, {}, None
    while True:
        marker, pos = imageio._next_marker(data, pos)
        length = struct.unpack(">H", data[pos:pos + 2])[0]
        seg = data[pos - 2:pos + length]
        if marker == 0xDA:
            sos = data[pos + 2:pos + length]
            break
        if marker in (0xDB, 0xC0, 0xC4):
            head += seg
        if marker == 0xC4:
            body, i = data[pos + 2:pos + length], 0
            while i < len(body):
                n = sum(body[i + 1:i + 17])
                tables[body[i]] = _huffman_codes(body[i + 1:i + 17],
                                                 body[i + 17:i + 17 + n])
                i += 17 + n
        pos += length
    if restart:
        head += b"\xff\xdd\x00\x04" + struct.pack(">H", restart)
    for j in range(sos[0]):
        cid, td_ta = sos[1 + 2 * j], sos[2 + 2 * j]
        i = frame.ids.index(cid)
        dc, ac = tables[td_ta >> 4], tables[0x10 | (td_ta & 15)]
        head += b"\xff\xda\x00\x08\x01" + bytes([cid, td_ta, 0, 63, 0])
        blocks = frame.blocks(i)[:-(-frame.ch[i] // 8), :-(-frame.cw[i] // 8)]
        w, pred, rst = _BitWriter(), 0, 0
        for n, block in enumerate(blocks.reshape(-1, 64)):
            if restart and n and n % restart == 0:
                w.flush()
                w.out += bytes([0xFF, 0xD0 + rst % 8])
                rst, pred = rst + 1, 0
            pred = _code_block(w, block, pred, dc, ac)
        w.flush()
        head += w.out
    return bytes(head + b"\xff\xd9")


@pytest.mark.parametrize("restart", [0, 7])
@pytest.mark.parametrize("source", ["fixture", "422", "gray"])
def test_single_component_scans_equal_cv2(source, restart):
    if source == "fixture":
        data = FRAMES[0].read_bytes()
    else:
        ok, buf = cv2.imencode(".jpg", _image(179, 241, source == "gray"), [
            cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            SAMPLING["422"]])
        data = buf.tobytes()
    recoded = _recode_one_scan_per_component(data, restart)
    assert recoded.count(b"\xff\xda") == (1 if source == "gray" else 3)
    _same_as_cv2(recoded)
    assert np.array_equal(decode_jpeg(recoded), decode_jpeg(data))


def _patched(data: bytes, old: bytes, new: bytes) -> bytes:
    i = data.index(old)
    return data[:i] + new + data[i + len(old):]


def test_unsupported_kinds_raise(tmp_path):
    im = _image(64, 80)
    ok, prog = cv2.imencode(".jpg", im, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValueError, match="progressive"):
        decode_jpeg(prog.tobytes())
    base = cv2.imencode(".jpg", im)[1].tobytes()
    with pytest.raises(ValueError, match="arithmetic-coded"):
        decode_jpeg(_patched(base, b"\xff\xc0", b"\xff\xc9"))
    with pytest.raises(ValueError, match="lossless"):
        decode_jpeg(_patched(base, b"\xff\xc0", b"\xff\xc3"))
    sof = base.index(b"\xff\xc0")
    twelve = base[:sof + 4] + b"\x0c" + base[sof + 5:]
    with pytest.raises(ValueError, match="12-bit"):
        decode_jpeg(twelve)
    with pytest.raises(ValueError, match="not a JPEG"):
        decode_jpeg(b"\x89PNG....")
    sos = base.index(b"\xff\xda")
    with pytest.raises(ValueError, match="invalid JPEG scan header"):
        decode_jpeg(base[:sos + 4] + b"\x09" + base[sos + 5:])  # Ns = 9
    # no JFIF marker and component ids 'R', 'G', 'B' (in frame and scan)
    rgb = bytearray(_patched(base, b"JFIF\x00", b"JFXX\x00"))
    sof, sos = rgb.index(b"\xff\xc0"), rgb.index(b"\xff\xda")
    for j, cid in enumerate(b"RGB"):
        rgb[sof + 10 + 3 * j] = rgb[sos + 5 + 2 * j] = cid
    with pytest.raises(ValueError, match="RGB-coded"):
        decode_jpeg(bytes(rgb))
    path = tmp_path / "p.jpg"
    path.write_bytes(prog.tobytes())
    with pytest.raises(ValueError, match="p.jpg: progressive"):
        imread(path)


def test_imread_dispatches_on_the_signature(tmp_path, monkeypatch):
    """A JPEG named .png and a PNG named .jpg read by their contents, with
    cv2 unimportable; another format still needs cv2."""
    jpg = tmp_path / "frame.png"
    jpg.write_bytes(FRAMES[1].read_bytes())
    png = tmp_path / "frame.jpg"
    png.write_bytes(HOLDOUT_PNG.read_bytes())
    ref_jpg, ref_png = cv2.imread(str(FRAMES[1])), cv2.imread(str(HOLDOUT_PNG))
    ref_gray = cv2.imread(str(FRAMES[1]), cv2.IMREAD_GRAYSCALE)
    bmp = tmp_path / "x.bmp"
    cv2.imwrite(str(bmp), ref_png[:8, :8])
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    assert np.array_equal(imread(jpg), ref_jpg)
    assert np.array_equal(imread(png), ref_png)
    assert np.array_equal(imread_gray(jpg), ref_gray)
    assert imread_gray(tmp_path / "missing.jpg") is None
    with pytest.raises(FileNotFoundError):
        imread(tmp_path / "missing.jpg")
    with pytest.raises(ImportError):
        imread(bmp)


def test_entropy_library_builds_into_the_port():
    from accelerated_features_tpu_torch.utils import native
    path = native.library_path(imageio._ENTROPY_SOURCE, "jpeg_entropy")
    decode_jpeg(FRAMES[0].read_bytes())
    assert path.parent == native.BUILD_ROOT and path.exists()


# -- the encoder -------------------------------------------------------------

ENCODE_SIZES = [(1, 1), (7, 9), (17, 33), (240, 320), (608, 800)]


def _content(kind, h, w, gray):
    if kind == "noise":
        rng = np.random.default_rng(h * 1000 + w)
        im = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        return im[..., 1].copy() if gray else im
    return _image(h, w, gray)


@pytest.mark.parametrize("size", ENCODE_SIZES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["noise", "rendered"])
@pytest.mark.parametrize("gray", [False, True], ids=["color", "gray"])
def test_encode_equals_cv2(size, kind, gray):
    im = _content(kind, *size, gray)
    ref = cv2.imencode(".jpg", im)[1].tobytes()
    got = imageio.encode_jpeg(im)
    assert got == ref, f"{len(got)} vs {len(ref)} bytes"
    back = cv2.imdecode(np.frombuffer(ref, np.uint8), cv2.IMREAD_UNCHANGED)
    assert np.array_equal(decode_jpeg(got, gray), back)


@pytest.mark.parametrize("quality", [1, 10, 50, 75, 90, 100])
@pytest.mark.parametrize("size", [(17, 33), (240, 320)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_encode_quality_grid_equals_cv2(quality, size):
    for gray in (False, True):
        im = _content("rendered", *size, gray)
        ref = cv2.imencode(".jpg", im, [cv2.IMWRITE_JPEG_QUALITY,
                                        quality])[1].tobytes()
        assert imageio.encode_jpeg(im, quality) == ref


def test_write_jpeg_equals_cv2_imwrite(tmp_path):
    im = _content("rendered", 240, 320, False)
    cv2.imwrite(str(tmp_path / "cv2.jpg"), im)
    imageio.write_jpeg(tmp_path / "port.jpg", im)
    assert (tmp_path / "port.jpg").read_bytes() == \
        (tmp_path / "cv2.jpg").read_bytes()
    assert np.array_equal(read_jpeg(tmp_path / "port.jpg"),
                          cv2.imread(str(tmp_path / "cv2.jpg")))


@pytest.mark.parametrize("bad", [np.zeros((4, 4, 3), np.float32),
                                 np.zeros((4, 4, 4), np.uint8),
                                 np.zeros((0, 4), np.uint8),
                                 np.zeros((4,), np.uint8)],
                         ids=["float", "4-channel", "empty", "1-d"])
def test_encode_refuses_other_arrays(bad):
    with pytest.raises(ValueError):
        imageio.encode_jpeg(bad)


# -- resize ----------------------------------------------------------------

RESIZE_TO = [(480, 640), (240, 320), (479, 641), (608, 800), (100, 37),
             (960, 1280), (13, 7), (1, 1), (160, 213), (481, 639)]


@pytest.mark.parametrize("channels", [None, 1, 3, 4])
def test_resize_uint8_equals_cv2(channels):
    """Down, up, mixed, and the exact halving (cv2's INTER_AREA there)."""
    rng = np.random.default_rng(channels or 0)
    for h, w in ((480, 640), (37, 53), (7, 5)):
        shape = (h, w) if channels is None else (h, w, channels)
        im = rng.integers(0, 256, shape, dtype=np.uint8)
        for oh, ow in RESIZE_TO:
            ref = cv2.resize(im, (ow, oh))
            got = resize(im, (oh, ow))
            assert got.shape == ref.shape and got.dtype == np.uint8
            assert np.array_equal(got, ref), (shape, (oh, ow))
    frame = read_jpeg(FRAMES[2])
    for oh, ow in ((240, 320), (608, 800), (352, 480)):
        assert np.array_equal(resize(frame, (oh, ow)),
                              cv2.resize(frame, (ow, oh)))
    assert resize(frame, (480, 640)) is frame


@pytest.mark.parametrize("channels", [None, 3])
def test_resize_float32_within_rounding_of_cv2(channels):
    """Within 1e-6 of the image's largest magnitude; most pixels differ in
    the last bits (cv2 weighs in more than float32 precision), so the
    mismatch count is not held, only the bound."""
    rng = np.random.default_rng(7)
    for h, w in ((480, 640), (37, 53)):
        shape = (h, w) if channels is None else (h, w, channels)
        im = (rng.standard_normal(shape) * 50).astype(np.float32)
        for oh, ow in RESIZE_TO:
            ref = cv2.resize(im, (ow, oh))
            got = resize(im, (oh, ow))
            assert got.shape == ref.shape and got.dtype == np.float32
            err = np.abs(got.astype(np.float64) - ref).max()
            assert err <= 1e-6 * np.abs(im).max(), (shape, (oh, ow), err)
