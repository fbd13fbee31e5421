"""The port's ASF demuxer (``v2e2v_tpu_torch/utils/asf.py`` behind
``utils/video.VideoFile``, ``data/video_readers.VideoReader`` and
``data/manifests.VideoSequence``) against cv2, FFmpeg's demuxer and the JAX
package's readers, on the ``.wmv`` fixtures of ``tests/data/wmv``
(``scripts/make_wmv_fixtures.py``) and on files written here:

- every ``.wmv`` clip (WMV1, WMV2, MS-MPEG-4 v2 and v3, MPEG-4 Part 2,
  Sorenson H.263 and MJPEG in ASF, the 960x720 flagship whose I-pictures
  span packets, the rate and count sweep, odd sizes, ASF files written with
  single and multiple payloads and every length type) through the port
  equals the records (cv2's fps, count, BGR and gray frames; the JAX
  readers' frames, stamps and hashes); this needs no cv2;
- the records are what cv2 and the JAX readers return, and the demuxer's
  packets are FFmpeg's (``scripts/probe_ffmpeg.py``);
- cv2's frame rate and count of ASF files written at rates and lengths
  swept here (FFmpeg's guess from millisecond stamps);
- every refusal names what the file is and ROADMAP item 4.
"""

import importlib.util
import json
import struct
import sys
from pathlib import Path

import numpy as np
import pytest

from v2e2v_tpu_torch.data.manifests import VideoSequence
from v2e2v_tpu_torch.data.video_readers import VideoReader
from v2e2v_tpu_torch.utils import asf
from v2e2v_tpu_torch.utils.video import VideoFile

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "data" / "wmv"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())["clips"]
CLIPS = sorted(n for n in MANIFEST if n.endswith(".wmv"))


def _module(name, path):
    sys.path.insert(0, str(REPO / "scripts"))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


RAW = _module("test_torch_rawvideo", REPO / "tests" / "test_torch_rawvideo.py")
WF = _module("make_wmv_fixtures", REPO / "scripts" / "make_wmv_fixtures.py")
_BGR: dict = {}  # the path -> the port's BGR frames: each clip decoded once a process


@pytest.fixture
def shared_bgr(monkeypatch):
    original = VideoFile.bgr

    def bgr(self):
        if self.path not in _BGR:
            _BGR[self.path] = list(original(self))
        return iter(_BGR[self.path])

    monkeypatch.setattr(VideoFile, "bgr", bgr)


@pytest.mark.parametrize("name", CLIPS)
def test_fixtures_match_records(name, shared_bgr):
    """Each ``.wmv`` clip through the port against cv2's frames, rate and
    count and the JAX readers' records."""
    RAW.clip_against_records(FIXTURES, MANIFEST, name)


@pytest.mark.parametrize("name", CLIPS)
def test_records_match_cv2_and_the_jax_readers(name):
    RAW.records_against_cv2(FIXTURES, MANIFEST, name)


@pytest.mark.parametrize("name", CLIPS)
def test_packets_are_ffmpegs(name, capfd):
    """The demuxer's media objects, whole, are the packets FFmpeg's ``asf``
    demuxer returns."""
    pytest.importorskip("cv2")
    probe = _module("probe_ffmpeg", REPO / "scripts" / "probe_ffmpeg.py")
    assert asf.AsfFile(str(FIXTURES / name)).packets == probe.demux(str(FIXTURES / name))


def test_fixtures_cover_what_they_are_there_for():
    """Every codec cv2 writes into ASF, I-pictures spread over packets,
    multiple-payload packets and padding, the rates FFmpeg guesses (30 fps
    as 359/12 at 6 frames, 29.97 as 30000/1001 at 17, 2 frames as 1000 fps)
    and the odd sizes."""
    codecs = {MANIFEST[n]["codec"] for n in CLIPS}
    assert codecs == {"wmv1", "wmv2", "msmpeg4v2", "msmpeg4v3", "mpeg4", "flv", "mjpeg"}
    flagship = asf.AsfFile(str(FIXTURES / "flagship.wmv"))
    assert len(flagship.packets[0]) > 2 * flagship.packet_size
    assert MANIFEST["r30_6.wmv"]["fps"] == 359 / 12
    assert MANIFEST["r2997_17.wmv"]["fps"] == 30000 / 1001
    assert (MANIFEST["r1_2.wmv"]["fps"], MANIFEST["r1_2.wmv"]["frame_count"]) == (1000.0, 2000)
    assert MANIFEST["odd_wmv2.wmv"]["shape"] == [95, 129]
    assert MANIFEST["flagship.wmv"]["shape"] == [720, 960]
    single = (FIXTURES / "asf_single.wmv").read_bytes()
    assert single[single.index(asf.uuid.UUID(asf.DATA).bytes_le) + 50 + 3] & 1 == 0


def test_std_framerates_are_ffmpegs_candidates():
    """``get_std_framerate``: 1/12 to 30 fps in steps of 1/12, 31 to 60,
    80, 120 and 240, then the NTSC rates of 24, 30, 60, 12, 15 and 48."""
    rates = [asf.std_framerate(i) / (12 * 1001) for i in range(asf.STD_RATES)]
    assert rates[:360] == [(i + 1) / 12 for i in range(360)]
    assert rates[360:390] == list(range(31, 61))
    assert rates[390:393] == [80, 120, 240]
    assert rates[393:] == [r * 1000 / 1001 for r in (24, 30, 60, 12, 15, 48)]


SWEEP = [(30.0, 3), (30.0, 41), (29.97, 5), (25.0, 17), (24.0, 2), (23.976, 45), (12.5, 9),
         (60.0, 5), (100.0, 3), (5.0, 33), (1.0, 4), (7.5, 3)]


@pytest.mark.parametrize("fps,frames", SWEEP)
def test_rate_and_count_match_cv2(tmp_path, fps, frames):
    """cv2's rate and count of WMV2 ASF files written at rates and lengths
    swept here, frames equal."""
    cv2 = pytest.importorskip("cv2")
    path = tmp_path / "clip.wmv"
    imgs = np.random.default_rng(frames).integers(0, 256, (frames, 16, 16, 3), np.uint8)
    RAW.FX.writer(path, imgs, fps, "WMV2")
    cap = cv2.VideoCapture(str(path), cv2.CAP_FFMPEG, [cv2.CAP_PROP_N_THREADS, 1])
    want = (cap.get(cv2.CAP_PROP_FPS), cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    video = VideoFile(str(path))
    assert (video.fps, video.frame_count) == want
    got = [RAW._sha(f) for f in video]
    assert got == [RAW._sha(cv2.cvtColor(f, cv2.COLOR_BGR2GRAY)) for f in RAW._cv2_bgr(path)]


WRITTEN = {"single_16": dict(packet_size=200, multiple=False, types=(2, 2, 1), length_type=2,
                             pad_type=2),
           "single_32": dict(packet_size=300, multiple=False, types=(3, 3, 3), length_type=3,
                             pad_type=1),
           "multi_8": dict(packet_size=250, types=(1, 2, 1), length_type=1, pad_type=2,
                           per_packet=2),
           "multi_no_length": dict(packet_size=1000, types=(1, 3, 2), pad_type=3, preroll=0)}


@pytest.mark.parametrize("case", sorted(WRITTEN))
def test_written_asf_matches_cv2(tmp_path, case):
    """ASF files written here from a cv2 clip's packets (single or multiple
    payloads, each length type, packets cut anywhere, padding) read as cv2
    reads them."""
    cv2 = pytest.importorskip("cv2")
    src = asf.AsfFile(str(FIXTURES / "wmv2.wmv"))
    path = tmp_path / "clip.wmv"
    stamps = [100 * i for i in range(len(src.packets))]
    WF.write_asf(path, src.packets, stamps, src.width, src.height, b"WMV2", src.extradata,
                 **WRITTEN[case])
    frames, fps, count = RAW.FX.cv2_frames(path)
    video = VideoFile(str(path))
    assert (video.fps, video.frame_count) == (fps, count)
    assert [RAW._sha(f) for f in video.bgr()] == [RAW._sha(f) for f in frames]
    assert len(frames) == len(src.packets)


@pytest.mark.parametrize("steps", [(42, 44), (40, 44), (40, 40, 41)])
def test_rate_from_stamp_differences(tmp_path, steps):
    """Past 15 stamp differences FFmpeg takes 1000 ms over their common
    divisor where it is above 2 ms (44 and 40 ms: 250 fps), else its
    guess among the standard rates (44 and 42 ms; 40, 40 and 41): files of
    19 pictures written here at those steps read as cv2 reads them."""
    cv2 = pytest.importorskip("cv2")
    src = asf.AsfFile(str(FIXTURES / "wmv2.wmv"))
    packets = src.packets[:1] + src.packets[1:] * 6
    stamps = list(np.cumsum([0] + [steps[k % len(steps)] for k in range(len(packets) - 1)]))
    path = tmp_path / "clip.wmv"
    WF.write_asf(path, packets, [int(t) for t in stamps], src.width, src.height, b"WMV2",
                 src.extradata)
    frames, fps, count = RAW.FX.cv2_frames(path)
    video = VideoFile(str(path))
    assert (video.fps, video.frame_count) == (fps, count)
    assert [RAW._sha(f) for f in video.bgr()] == [RAW._sha(f) for f in frames]


def _refused(tmp_path, case):
    data = (FIXTURES / "wmv2.wmv").read_bytes()
    path = tmp_path / "clip.wmv"
    if case == "wmv3":
        data = data.replace(b"WMV2", b"WMV3")
    elif case == "two_streams":
        data = WF.second_video_stream(data)
    elif case == "encrypted":
        data = WF.add_header_object(data, WF._obj(asf.CONTENT_ENCRYPTION[0], bytes(16)))
    elif case == "extended_stream":
        data = WF.add_header_object(data, WF._obj(asf.HEADER_EXTENSION, bytes(16) + struct.pack(
            "<HI", 6, 24 + 64) + WF._obj(asf.EXTENDED_STREAM_PROPERTIES, bytes(64))))
    elif case in ("error_correction", "broadcast", "file_size"):
        data = bytearray(data)
        for pos, size in WF._header_objects(bytes(data)):
            guid = bytes(data[pos:pos + 16])
            if case == "error_correction" and guid == WF._guid(asf.STREAM_PROPERTIES):
                data[pos + 24 + 16:pos + 24 + 32] = WF._guid(asf.VIDEO_MEDIA)
            if guid == WF._guid(asf.FILE_PROPERTIES):
                if case == "broadcast":
                    data[pos + 24 + 64] |= 1
                elif case == "file_size":
                    struct.pack_into("<Q", data, pos + 24 + 16, 2 * len(data))
        data = bytes(data)
    elif case == "truncated":
        data = data[:len(data) - 150]
        path.write_bytes(data)
        flagship = (FIXTURES / "flagship.wmv").read_bytes()
        data = flagship[:flagship.index(asf.uuid.UUID(asf.DATA).bytes_le) + 50 + 2000]
    elif case == "compressed":
        k = data.index(asf.uuid.UUID(asf.DATA).bytes_le) + 50
        flags, sizes = data[k + 3], (0, 1, 2, 4)
        assert flags & 1 and data[k + 4] & 3 == 1  # multiple payloads; 1-byte replicated length
        first = k + 5 + sum(sizes[flags >> s & 3] for s in (5, 1, 3)) + 6 + 1
        data = bytearray(data)
        data[first + 1 + 1 + 4] = 1  # the first payload's replicated length
        data = bytes(data)
    elif case == "not_asf":
        data = asf.HEADER_GUID[:8] + bytes(100)
    path.write_bytes(data)
    return path


REFUSALS = {"wmv3": "codec 'WMV3' \\(biCompression: WMV3 \\(VC-1\\)\\)",
            "two_streams": "more than one video stream", "encrypted": "encrypted",
            "extended_stream": "Extended Stream Properties",
            "error_correction": "error correction", "broadcast": "broadcast",
            "file_size": "file size", "truncated": "corrupt or truncated ASF",
            "compressed": "compressed ASF payloads", "not_asf": "unknown format|not RIFF"}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_name_item_4(tmp_path, case):
    """What the port leaves (WMV3, a second video stream, encryption,
    Extended Stream Properties, error correction data, a broadcast file or a
    file size that is not the file's, whose counts cv2 then estimates,
    truncated data, compressed payloads, a file that only starts like ASF)
    raises naming it and ROADMAP item 4, from both readers."""
    path = str(_refused(tmp_path, case))
    with pytest.raises(ValueError, match=f"(?s)({REFUSALS[case]}).*item 4"):
        VideoReader((180, 240)).initialize(path)
    with pytest.raises(ValueError, match="item 4"):
        list(VideoSequence(path))
