"""The port's FLV demuxer (``v2e2v_tpu_torch/utils/flv.py``) against cv2 and
FFmpeg's ``libavformat/flvdec.c``, on the FLV clips of ``tests/data/h263``
(``scripts/make_h263_fixtures.py``) and on files rewritten or written here
(``write_flv``):

- every fixture's packets equal cv2's raw mode (``CAP_PROP_FORMAT = -1``);
- ``fps`` and ``frame_count`` equal ``CAP_PROP_FPS`` and
  ``CAP_PROP_FRAME_COUNT`` on rewritten metadata (framerate, duration, a
  duration given twice, none at all, the last tag's stamp 0), on an
  ``onMetaData`` object instead of an ECMA array, beside audio tags, other
  script tags and video command frames;
- ``av_d2q`` equals libavutil's on random rates;
- every refusal names what the file is and ROADMAP item 4.
"""

import ctypes
import importlib.util
import json
import struct
from pathlib import Path

import numpy as np
import pytest

from v2e2v_tpu_torch.data.video_readers import VideoReader
from v2e2v_tpu_torch.utils.flv import FlvFile, av_d2q
from v2e2v_tpu_torch.utils.video import VideoFile

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "data" / "h263"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())["clips"]
FLVS = sorted(n for n in MANIFEST if n.endswith(".flv"))


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FX = _module("make_h263_fixtures", REPO / "scripts" / "make_h263_fixtures.py")


def _raw_packets(cv2, path):
    cap = cv2.VideoCapture(str(path), cv2.CAP_FFMPEG, [cv2.CAP_PROP_FORMAT, -1])
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f.tobytes())
    cap.release()
    return out


def _cv2_rate(cv2, path):
    cap = cv2.VideoCapture(str(path), cv2.CAP_FFMPEG)
    out = cap.get(cv2.CAP_PROP_FPS), cap.get(cv2.CAP_PROP_FRAME_COUNT)
    cap.release()
    return out


@pytest.mark.parametrize("name", FLVS)
def test_packets_match_cv2_raw_mode(name):
    """Each FLV fixture's video packets, as cv2's demuxer hands them on."""
    cv2 = pytest.importorskip("cv2")
    flv = FlvFile(str(FIXTURES / name))
    assert list(flv.frames()) == _raw_packets(cv2, FIXTURES / name)
    assert (flv.fps, flv.frame_count) == _cv2_rate(cv2, FIXTURES / name)


def _tags(data: bytes) -> list[bytes]:
    """The file header and PreviousTagSize0, then each tag with its size."""
    out, pos = [data[:13]], 13
    while pos + 11 <= len(data):
        size = int.from_bytes(data[pos + 1:pos + 4], "big")
        out.append(data[pos:pos + 15 + size])
        pos += 15 + size
    return out


def _meta_value(data: bytes, key: bytes, value: float) -> bytes:
    at = data.index(key) + len(key) + 1
    return data[:at] + struct.pack(">d", value) + data[at + 8:]


def _rewrite(data: bytes, case: str) -> bytes:
    tags = _tags(data)
    meta = FX.amf_metadata
    if case == "framerate_15":
        return _meta_value(data, b"framerate", 15.0)
    if case == "framerate_2997":
        return _meta_value(data, b"framerate", 30000 / 1001)
    if case == "framerate_huge":  # av_d2q(x, 1000) of anything past 1000 is 1000
        return _meta_value(data, b"framerate", 1e6)
    if case == "duration_2":
        return _meta_value(data, b"duration", 2.0)
    if case == "no_duration":  # the last tag's stamp then
        return data.replace(b"duration", b"duratioX")
    if case == "duration_0":
        return _meta_value(data, b"duration", 0.0)
    if case == "last_stamp_0":  # the stamp of the tag before it then
        last = bytearray(tags[-1])
        last[4:8] = bytes(4)
        return b"".join(tags[:-1]) + bytes(last).replace(b"duration", b"duratioX")
    if case == "duration_twice":  # the last one counts
        body = meta({"duration": 9.0, "framerate": 10.0})[:-3]
        body += FX._amf_key("duration") + FX._amf_number(1.4) + b"\x00\x00\x09"
        return tags[0] + FX.flv_tag(18, 0, body) + b"".join(tags[2:])
    if case == "object":  # onMetaData as an AMF object, with other value types
        body = (b"\x02" + FX._amf_key("onMetaData") + b"\x03"
                + FX._amf_key("encoder") + b"\x02" + FX._amf_key("Lavf")
                + FX._amf_key("stereo") + b"\x01\x00"
                + FX._amf_key("keyframes") + b"\x03" + FX._amf_key("times") + b"\x0a"
                + struct.pack(">I", 2) + FX._amf_number(0.0) + FX._amf_number(1.0)
                + b"\x00\x00\x09"
                + FX._amf_key("framerate") + FX._amf_number(10.0)
                + FX._amf_key("duration") + FX._amf_number(0.8) + b"\x00\x00\x09")
        return tags[0] + FX.flv_tag(18, 0, body) + b"".join(tags[2:])
    if case == "interleaved":  # audio tags, another script tag, command frames
        audio = FX.flv_tag(8, 0, b"\x2e" + bytes(40))
        other = FX.flv_tag(18, 0, b"\x02" + FX._amf_key("onCuePoint") + b"\x05")
        command = FX.flv_tag(9, 0, b"\x52\x00")
        body = [tags[0], other, tags[1]]
        for tag in tags[2:]:
            body += [audio, tag, command]
        return b"".join(body)
    raise KeyError(case)


REWRITES = ["framerate_15", "framerate_2997", "framerate_huge", "duration_2", "no_duration",
            "duration_0", "last_stamp_0", "duration_twice", "object", "interleaved"]


@pytest.mark.parametrize("case", REWRITES)
def test_rate_and_count_match_cv2_on_rewrites(tmp_path, case):
    """``fps``, ``frame_count`` and the packets of rewritten FLVs against
    cv2: the metadata's framerate through ``av_d2q(x, 1000)``, its duration
    (the last one given), the last tag's stamp where it has none, the
    layouts cv2 passes over."""
    cv2 = pytest.importorskip("cv2")
    path = tmp_path / "clip.flv"
    path.write_bytes(_rewrite((FIXTURES / "gop.flv").read_bytes(), case))
    flv = FlvFile(str(path))
    assert (flv.fps, flv.frame_count) == _cv2_rate(cv2, path)
    assert list(flv.frames()) == _raw_packets(cv2, path)


def test_written_flvs_match_cv2(tmp_path):
    """``write_flv``'s files (the tests' crafted streams go in them) read by
    cv2 at their rate and count, and by the port frame for frame."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(11)
    for fps, n in ((10.0, 3), (12.5, 4), (30000 / 1001, 5)):
        pics = [FX.random_picture(rng, "flv", int(i > 0), 40, 24) for i in range(n)]
        path = tmp_path / f"w{n}.flv"
        FX.write_flv(path, pics, fps, 40, 24)
        assert (FlvFile(str(path)).fps, FlvFile(str(path)).frame_count) == _cv2_rate(cv2, path)
        cap = cv2.VideoCapture(str(path), cv2.CAP_FFMPEG, [cv2.CAP_PROP_N_THREADS, 1])
        want = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            want.append(f)
        got = list(VideoFile(str(path)).bgr())
        assert len(got) == len(want) == n
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_av_d2q_matches_libavutil():
    """``av_d2q(x, 1000)`` against libavutil's own on random rates and the
    common ones."""
    pytest.importorskip("cv2")
    probe = _module("probe_ffmpeg", REPO / "scripts" / "probe_ffmpeg.py")
    util = probe._libs()[0]

    class Rational(ctypes.Structure):
        _fields_ = [("num", ctypes.c_int), ("den", ctypes.c_int)]

    util.av_d2q.restype = Rational
    util.av_d2q.argtypes = [ctypes.c_double, ctypes.c_int]
    rng = np.random.default_rng(5)
    rates = [23.976, 24000 / 1001, 29.97, 30000 / 1001, 59.94, 12.34, 0.001, 1e6 / 7]
    rates += list(rng.uniform(0.01, 240.0, 200)) + list(rng.uniform(0.0001, 0.01, 20))
    for r in rates:
        want = util.av_d2q(float(r), 1000)
        assert av_d2q(float(r), 1000) == (want.num, want.den), r


def _refused(tmp_path, case) -> Path:
    data = (FIXTURES / "gop.flv").read_bytes()
    tags = _tags(data)
    video = [t for t in tags[1:] if t[0] == 9]
    if case in ("vp6", "avc", "screen"):
        codec = {"vp6": 4, "avc": 7, "screen": 3}[case]
        data = b"".join(t[:11] + bytes([t[11] & 0xF0 | codec]) + t[12:] if t[0] == 9 else t
                        for t in tags)
    elif case == "enhanced":
        first = video[0]
        data = data.replace(first, first[:11] + bytes([0x90]) + b"avc1" + first[12:])
    elif case == "no_framerate":
        data = data.replace(b"framerate", b"framerats")
    elif case == "framerate_0":
        data = _meta_value(data, b"framerate", 0.0)
    elif case == "framerate_tiny":  # under 1/2000: av_d2q(x, 1000) gives 0/1
        data = _meta_value(data, b"framerate", 0.0004)
    elif case == "no_video":
        data = tags[0] + tags[1]
    elif case == "encrypted":
        data = data.replace(video[0], bytes([video[0][0] | 0x20]) + video[0][1:])
    elif case == "truncated":
        data = data[:-40]
    elif case == "empty_tag":
        data = data + FX.flv_tag(9, 2000, b"")
    elif case == "no_duration_at_all":  # neither the metadata's nor a tag's stamp
        stamps = [t[:4] + bytes(4) + t[8:] for t in tags[1:]]
        data = (tags[0] + b"".join(stamps)).replace(b"duration", b"duratioX")
    else:
        raise KeyError(case)
    path = tmp_path / "clip.flv"
    path.write_bytes(data)
    return path


FLV_REFUSALS = {"vp6": "On2 VP6 \\(codec id 4\\)", "avc": "AVC", "screen": "Screen video",
                "enhanced": "enhanced-FLV", "no_framerate": "framerate None",
                "framerate_0": "framerate 0.0", "framerate_tiny": "reads as 0/1",
                "no_video": "no video",
                "encrypted": "encrypted", "truncated": "corrupt or truncated FLV",
                "empty_tag": "empty FLV video tag", "no_duration_at_all": "duration 0 us"}


@pytest.mark.parametrize("case", sorted(FLV_REFUSALS))
def test_flv_refusals_name_item_4(tmp_path, case):
    """FLVs the port does not read (other video codecs and enhanced-FLV
    tags, no ``framerate``, or one that reads as a rate of 0, no video, encrypted or empty
    video tags, a truncated file, no duration to count by) raise naming
    what they are and ROADMAP item 4, from the reader the CLIs use."""
    path = _refused(tmp_path, case)
    with pytest.raises(ValueError, match=f"(?s){FLV_REFUSALS[case]}.*item 4"):
        VideoReader((180, 240)).initialize(str(path))


def test_not_flv_is_refused(tmp_path):
    path = tmp_path / "clip.flv"
    path.write_bytes(b"FLX" + bytes(20))
    with pytest.raises(ValueError, match="item 4"):
        FlvFile(str(path))
