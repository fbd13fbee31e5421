#!/usr/bin/env python3
"""Probe the FFmpeg that cv2 bundles (``opencv_python.libs/libav*.so``)
through ``ctypes``, below cv2: what its demuxer makes of a file and what a
named decoder gives before swscale.

    python scripts/probe_ffmpeg.py clip.webm                  # av_dump_format, packets
    python scripts/probe_ffmpeg.py clip.webm --decode vp8     # planes by FFmpeg's vp8
    python scripts/probe_ffmpeg.py clip.webm --decode libvpx --threads 8

``demux(path)`` opens the file with ``avformat_open_input`` and
``avformat_find_stream_info``, prints ``av_dump_format``'s summary (fps,
tbr, tbn, duration) to stderr and returns the first video stream's packets
(``av_read_frame``). ``decode(packets, name, threads)`` feeds them to the
decoder ``name`` (``avcodec_send_packet`` / ``receive_frame``) and returns
each frame's Y, Cb and Cr planes (8-bit 4:2:0), to hold a port decoder
against FFmpeg's planes rather than cv2's BGR. Only AVFrame's and
AVPacket's leading fields are read (``data``, ``linesize``, ``width``,
``height``; ``data``, ``size``, ``stream_index``), which FFmpeg keeps in
place across versions. It needs cv2 (for its bundled libraries), so it runs
where the JAX package's dependencies are installed, not on the card's
machine.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import os

import numpy as np

P = ctypes.c_void_p


class _Frame(ctypes.Structure):
    _fields_ = [("data", P * 8), ("linesize", ctypes.c_int * 8), ("extended_data", P),
                ("width", ctypes.c_int), ("height", ctypes.c_int)]


class _Packet(ctypes.Structure):
    _fields_ = [("buf", P), ("pts", ctypes.c_int64), ("dts", ctypes.c_int64), ("data", P),
                ("size", ctypes.c_int), ("stream_index", ctypes.c_int)]


def _libs():
    import cv2

    where = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)), "opencv_python.libs")
    load = {}
    for name in ("avutil", "avcodec", "avformat"):
        load[name] = ctypes.CDLL(glob.glob(f"{where}/lib{name}-*.so*")[0], mode=ctypes.RTLD_GLOBAL)
    util, codec, fmt = load["avutil"], load["avcodec"], load["avformat"]
    codec.avcodec_find_decoder_by_name.restype = P
    codec.avcodec_find_decoder_by_name.argtypes = [ctypes.c_char_p]
    codec.avcodec_alloc_context3.restype = P
    codec.avcodec_alloc_context3.argtypes = [P]
    codec.avcodec_open2.argtypes = [P, P, ctypes.POINTER(P)]
    codec.av_packet_alloc.restype = P
    codec.avcodec_send_packet.argtypes = [P, P]
    codec.avcodec_receive_frame.argtypes = [P, P]
    codec.av_packet_unref.argtypes = [P]
    util.av_frame_alloc.restype = P
    util.av_frame_unref.argtypes = [P]
    util.av_dict_set.argtypes = [ctypes.POINTER(P), ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    fmt.avformat_open_input.argtypes = [ctypes.POINTER(P), ctypes.c_char_p, P, P]
    fmt.avformat_find_stream_info.argtypes = [P, P]
    fmt.av_dump_format.argtypes = [P, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    fmt.av_find_best_stream.argtypes = [P, ctypes.c_int, ctypes.c_int, ctypes.c_int, P,
                                        ctypes.c_int]
    fmt.av_read_frame.argtypes = [P, P]
    return util, codec, fmt


def demux(path: str) -> list[bytes]:
    """The first video stream's packets, as FFmpeg's demuxer reads them;
    ``av_dump_format``'s summary goes to stderr."""
    _, codec, fmt = _libs()
    ctx = P()
    if fmt.avformat_open_input(ctypes.byref(ctx), path.encode(), None, None) < 0:
        raise OSError(f"FFmpeg cannot open {path}")
    fmt.avformat_find_stream_info(ctx, None)
    fmt.av_dump_format(ctx, 0, path.encode(), 0)
    video = fmt.av_find_best_stream(ctx, 0, -1, -1, None, 0)  # AVMEDIA_TYPE_VIDEO
    pkt, out = codec.av_packet_alloc(), []
    while fmt.av_read_frame(ctx, pkt) >= 0:
        p = _Packet.from_address(pkt)
        if p.stream_index == video:
            out.append(ctypes.string_at(p.data, p.size))
        codec.av_packet_unref(pkt)
    return out


def decode(packets: list[bytes], name: str = "vp8", threads: int = 1,
           size: tuple[int, int] | None = None, extradata: bytes = b"") -> list[tuple]:
    """Each frame the decoder ``name`` returns for ``packets``, as (Y, Cb,
    Cr) uint8 planes of a 4:2:0 frame. ``size`` (width, height) and
    ``extradata`` are the container's, for decoders whose streams carry
    neither (``msmpeg4``, ``wmv2``): the size as the ``video_size`` option,
    the extradata at AVCodecContext's ``extradata`` (offset 72, which
    FFmpeg 5-8 keep)."""
    util, codec, _ = _libs()
    dec = codec.avcodec_find_decoder_by_name(name.encode())
    if not dec:
        raise ValueError(f"no decoder {name!r} in this FFmpeg")
    ctx = codec.avcodec_alloc_context3(dec)
    opts = P()
    util.av_dict_set(ctypes.byref(opts), b"threads", str(threads).encode(), 0)
    if size:
        util.av_dict_set(ctypes.byref(opts), b"video_size", f"{size[0]}x{size[1]}".encode(), 0)
    if extradata:
        util.av_mallocz.restype = P
        util.av_mallocz.argtypes = [ctypes.c_size_t]
        buf = util.av_mallocz(len(extradata) + 64)
        ctypes.memmove(buf, extradata, len(extradata))
        ctypes.c_void_p.from_address(ctx + 72).value = buf
        ctypes.c_int.from_address(ctx + 80).value = len(extradata)
    if codec.avcodec_open2(ctx, dec, ctypes.byref(opts)) < 0:
        raise OSError(f"cannot open the decoder {name!r}")
    pkt, frm, out, keep = codec.av_packet_alloc(), util.av_frame_alloc(), [], []

    def drain():
        while codec.avcodec_receive_frame(ctx, frm) >= 0:
            f = _Frame.from_address(frm)
            sizes = [(f.height, f.width)] + [((f.height + 1) // 2, (f.width + 1) // 2)] * 2
            planes = []
            for k, (h, w) in enumerate(sizes):
                raw = ctypes.string_at(f.data[k], f.linesize[k] * h)
                planes.append(np.frombuffer(raw, np.uint8).reshape(h, -1)[:, :w].copy())
            out.append(tuple(planes))
            util.av_frame_unref(frm)

    for data in packets + [None]:
        if data is None:
            codec.avcodec_send_packet(ctx, None)
        else:
            buf = ctypes.create_string_buffer(data + bytes(64), len(data) + 64)  # padded
            keep.append(buf)
            p = _Packet.from_address(pkt)
            p.buf, p.data, p.size = None, ctypes.addressof(buf), len(data)
            codec.avcodec_send_packet(ctx, pkt)
        drain()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path")
    ap.add_argument("--decode", metavar="DECODER", help="e.g. vp8, libvpx, mpeg4, mjpeg")
    ap.add_argument("--threads", type=int, default=1)
    args = ap.parse_args()
    packets = demux(args.path)
    print(f"{len(packets)} packets: {[len(p) for p in packets[:12]]}")
    if args.decode:
        frames = decode(packets, args.decode, args.threads)
        for i, (y, cb, cr) in enumerate(frames):
            print(f"frame {i}: Y {y.shape} mean {y.mean():.3f}, Cb {cb.shape}, Cr {cr.shape}")


if __name__ == "__main__":
    main()
