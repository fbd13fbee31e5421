"""Lossy WebP images (``VP8 `` chunks) with numpy and plain Python:
``decode_vp8_bgr`` returns the BGR image that libwebp's ``WebPDecodeBGRInto``
gives OpenCV for a VP8 key frame, bit for bit.

The decoder follows RFC 6386 as libwebp implements it (``src/dec/*_dec.c``,
``src/dsp/dec.c``), which fixes every output value as an integer:

- the boolean entropy decoder; the frame header: segments (map
  probabilities, quantizer and filter-strength values, absolute or delta),
  the loop filter's type, level and sharpness and its reference and mode
  deltas, the token partitions, the quantizer indices and their five deltas,
  and the coefficient probability updates;
- per macroblock: the segment, the skip flag, the luma mode (16x16 DC, V, H,
  TM, or 4x4 ``B_PRED`` with ten sub-block modes whose probabilities depend
  on the modes above and to the left) and the chroma mode; the tokens with
  their contexts, dequantised; the inverse Walsh-Hadamard transform of the
  second-order DC block and the inverse DCT, in integers;
- intra prediction from the unfiltered frame, with libwebp's borders: 127
  above the frame, 129 to its left, and the pixels above-right of a 4x4
  block in the right column taken from above the macroblock (the pixel above
  its last column, repeated, at the frame's right edge);
- the simple or the normal loop filter on every macroblock edge and inner
  edge in raster order, with each segment's and mode's level, the interior
  limit from the sharpness, and the high-edge-variance threshold
  (``loop_filter``, which ``utils/vp8dec.py`` shares, vectorised over a
  wavefront of macroblocks that keeps raster order's result);
- then ``io_dec.c::EmitFancyRGB``: the chroma planes upsampled by libwebp's
  "fancy" upsampler (``(9 a + 3 b + 3 c + d + 8) / 16`` as its packed
  arithmetic rounds it) and each pixel converted by ``yuv.h::VP8YuvToBgr``
  at 14 bits.

The probability and quantizer tables are the RFC's (its ``coeff_update_probs``,
``default_coeff_probs``, ``kf_bmode_probs``, ``dc_qlookup`` and ``ac_qlookup``),
in libwebp's order of the sub-block modes. Inter frames, frames that are not
shown, and truncated or corrupt data raise a ValueError naming ROADMAP.md
queue 1, item 4.
"""

from __future__ import annotations

import numpy as np

from .imgcodecs import ROADMAP

COEFFS_PROBA0 = bytes.fromhex(
    "808080808080808080808080808080808080808080808080808080808080808080fd88feffe4db8080808080"
    "bd81f2ffe3d5ffdb8080806a7ee3fcd6d1ffff8080800162f8ffece2ffff808080b585eefeddeaff9a808080"
    "4e86caf7c6b4ffdb80808001b9f9fff3ff8080808080b896f7ffece080808080804d6ed8ffece68080808080"
    "0165fbfff1ff8080808080aa8bf1fcecd1ffff8080802574c4f3e4ffffff80808001ccfefff5ff8080808080"
    "cfa0faffee8080808080806667e7ffd3ab80808080800198fcfff0ff8080808080b187f3ffeae18080808080"
    "5081d3ffc2e080808080800101ff8080808080808080f601ff8080808080808080ff80808080808080808080"
    "c623eddfc1bba2a0919b3e832dc6ddacb0dc9dfcdd01442f92d095a7dda2ffdf800195f1ffdde0ffff808080"
    "b88deafddedcffc78080805163b5f2b0bef9caffff800181e8fdd6c5f2c4ffff806379d2fac9c6ffca808080"
    "175ba3f2aabbf7d2ffff8001c8f6ffeaff80808080806db2f1ffe7f5ffff8080802c82c9fdcdc0ffff808080"
    "0184effbdbd1ffa58080805e88e1fbdabeffff8080801664aef5baa1ffc780808001b6f9ffe8eb8080808080"
    "7c8ff1ffe3ea8080808080234db5fbc1d3ffcd808080019df7ffece7ffff808080798debffe1e3ffff808080"
    "2d63bcfbc3d9ffe08080800101fbffd5ff8080808080cb01f8ffff8080808080808901b1ffe0ff8080808080"
    "fd09f8fbcfd0ffc0808080af0de0f3c1b9f9c6ffff804911abdda1b3eca7ffea80015ff7fdd4b7ffff808080"
    "ef5af4fad3d1ffff8080809b4dc3f8bcc3ffff8080800118effbdadbffcd808080c933dbffc4ba8080808080"
    "452ebeefc9daffe480808001bffbffff808080808080dfa5f9ffd5ff80808080808d7cf8ffff808080808080"
    "0110f8ffff808080808080be24e6ffecff80808080809501ff808080808080808001e2ff8080808080808080"
    "f7c0ff8080808080808080f080ff80808080808080800186fcffff808080808080d53efaffff808080808080"
    "375dff8080808080808080808080808080808080808080808080808080808080808080808080808080808080"
    "ca18d5ebbabfdca0f0afff7e26b6e8a9b8e4aeffbb803d2e8adb97b2f0aaffd8800170e6fac7bff79fffff80"
    "a66de4fcd3d7ffae808080274da2e8acb4f5b2ffff800134dcf6c6c7f9dcffff807c4abff3b7c1faddffff80"
    "184782db9aaaf3b6ffff8001b6e1f9dbf0ffe08080809596e2fcd8cdffab8080801c6caaf2b7c2fedfffff80"
    "0151e6fccccbffc08080807b66d1f7bcc4ffe9808080145f99f3a4adffcb80808001def8ffd8d58080808080"
    "a8aff6fcebcdffff8080802f74d7ffd3d4ffff8080800179ecfdd4d6ffff8080808d54d5fcc9caffdb808080"
    "2a50a0f0a2b9ffcd8080800101ff8080808080808080f401ff8080808080808080ee01ff8080808080808080")
COEFFS_UPDATE_PROBA = bytes.fromhex(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffb0f6ffffffffffffffffff"
    "dff1fcfffffffffffffffff9fdfdfffffffffffffffffff4fcffffffffffffffffeafefeffffffffffffffff"
    "fdfffffffffffffffffffffff6feffffffffffffffffeffdfefffffffffffffffffefffeffffffffffffffff"
    "fff8fefffffffffffffffffbfffefffffffffffffffffffffffffffffffffffffffffdfeffffffffffffffff"
    "fbfefefffffffffffffffffefffefffffffffffffffffffefdfffefffffffffffffafffefffeffffffffffff"
    "feffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "d9ffffffffffffffffffffe1fcf1fdfffffeffffffffeafaf1fafdfffdfefffffffffeffffffffffffffffff"
    "dffefeffffffffffffffffeefdfefefffffffffffffffff8fefffffffffffffffff9feffffffffffffffffff"
    "fffffffffffffffffffffffffdfffffffffffffffffff7feffffffffffffffffffffffffffffffffffffffff"
    "fffdfefffffffffffffffffcfffffffffffffffffffffffffffffffffffffffffffffefeffffffffffffffff"
    "fdfffffffffffffffffffffffffffffffffffffffffffffefdfffffffffffffffffaffffffffffffffffffff"
    "feffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "bafbfaffffffffffffffffeafbf4fefffffffffffffffbfbf3fdfefffefffffffffffdfeffffffffffffffff"
    "ecfdfefffffffffffffffffbfdfdfefefffffffffffffffefefffffffffffffffffefefeffffffffffffffff"
    "fffffffffffffffffffffffffefffffffffffffffffffefefffffffffffffffffffeffffffffffffffffffff"
    "fffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "f8fffffffffffffffffffffafefcfefffffffffffffff8fef9fdfffffffffffffffffdfdffffffffffffffff"
    "f6fdfdfffffffffffffffffcfefbfefefffffffffffffffefcfffffffffffffffff8fefdffffffffffffffff"
    "fdfffefefffffffffffffffffbfefffffffffffffffff5fbfefffffffffffffffffdfdfeffffffffffffffff"
    "fffbfdfffffffffffffffffcfdfefffffffffffffffffffefffffffffffffffffffffcffffffffffffffffff"
    "f9fffefffffffffffffffffffffefffffffffffffffffffffdfffffffffffffffffaffffffffffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffff")
BMODES_PROBA = bytes.fromhex(
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabdabd110d98721a11a32cc3150a"
    "ad791850c31a3e2c405590470a26abd590221aaa2e371388a021ce473f14087272d00c09e251280b60b6541d"
    "102486b7598962656aa59448bb64829d6f204b504266a7634a3e28ea80293509b2f18d1a086b4a2b1a9249a6"
    "31179d412669a033341f7380684f0c1bd9ff5711075744472c72330fba172f290e6eb6b71511c2422d1966c5"
    "bd171216585893962a2e2dc4cd2b61b775552623b33d2735c8571a152be8ab3822336872661d5d4d271c55ab"
    "3aa55a6240221674ce17222ba6496b36201a3301512b1f44196a1640ab24e1722213156684bc104c7c3e124e"
    "5f5539323033c165239fd76f592e6f3c941facdbe415126f70714d55b3ff267872282a01c4f5d10a196d582b"
    "1d8ca6d5252b9a3d3f1e9b432d4401d16450082b9a01331a478e4e4e10ff8022c5ab29280566d3b70401dd33"
    "3211a8d1c01719528a1f24ab1ba6262ce543573aa952731a3bb33f3b5ab43ba65d499a282815748fd12227af"
    "2f0f10b722df312db72e1121b706620f20b7392e16188001361125412049731c801780cd2803097333c01206"
    "df572509733b4d40152f68372cda09363582e2405a46cd2829171a39363970b8052926a6d51e221a8598740a"
    "2086271335dd1a722049ff1f0941ea020f0176494b200c33c0ffa02b33581f2343665537ba553815176f3bcd"
    "2d25c03726467c49660122627d622a58685575af525f543559806471652d4b4f7b2f338051ab013911054766"
    "3935293126210d7939491a0155290a438a4d6e5a2f727315020a66ffa61706651d100a558065c41a39120a66"
    "66d522142b75140f24a38044011a663d472522351ff3c0453c472649771cde25442d8022012f0bf5ab3e1113"
    "469255373e46252b259a64a355a0013f095c881c4020c9554b0f090940ffb8771056061c0540ff19f8013808"
    "118489ff3774803a0f145287391a7928a4321f899a851923da33672c83837b1f069e5628408794e02db78016"
    "1a1183f09a0e01d12d10155b40de0701c53815279b3c8a1766d5530c0d36c0ff442f1c551a555580802092ab"
    "120b073f90ab0404f6231b0a92aeab0c1a80be502363b4507e362d557e2f57b033291420654b808b76927480"
    "5538290fb0ec5525093e471e117776ff11128a65263c8a37462b1a8e9224131eabff611b148a2d3d3edb0151"
    "bc4020291475978e1415a370130c3dc380300418")
DC_TABLE = bytes.fromhex(
    "0405060708090a0a0b0c0d0e0f101111121314141515161617171819191a1b1c1d1e1f202122232425252627"
    "28292a2b2c2d2e2e2f303132333435363738393a3b3c3d3e3f404142434445464748494a4b4c4c4d4e4f5051"
    "52535455565758595b5d5f6062646566686a6c6e707274767a7c7e80828486888a8c8f9194979a9d")
AC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27,
    28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50,
    51, 52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88,
    90, 92, 94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128, 131,
    134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189,
    193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269,
    274, 279, 284)

ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
CAT3456 = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
           (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# libwebp's sub-block modes; the 16x16 and chroma modes share the first four
B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU = range(10)
DC_PRED, TM_PRED, V_PRED, H_PRED = B_DC, B_TM, B_VE, B_HE
# tree_dec.c::kYModesIntra4: the sub-block mode tree (leaves as -mode)
YMODES_INTRA4 = (-B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE, 5, -B_RD, -B_VR, -B_LD, 7, -B_VL, 8,
                 -B_HD, -B_HU)
_NORM = [0] + [7 - v.bit_length() + 1 for v in range(1, 256)]  # shifts to bring a range >= 128


def _refused(path: str, what: str) -> ValueError:
    return ValueError(f"{path}: lossy WebP (VP8) {what} is not supported by the port's VP8 "
                      f"decoder ({ROADMAP})")


class _Bool:
    """RFC 6386's boolean decoder (section 7), its renormalisation by
    table."""

    def __init__(self, data: bytes, path: str):
        self.data, self.path = data, path
        self.value = int.from_bytes(data[:2].ljust(2, b"\0"), "big")
        self.pos, self.count, self.range = 2, 0, 255

    def bit(self, prob: int) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        big = split << 8
        if self.value >= big:
            out = 1
            self.range -= split
            self.value -= big
        else:
            out = 0
            self.range = split
        shift = _NORM[self.range]
        if shift:
            self.range <<= shift
            self.value <<= shift
            self.count += shift
            if self.count >= 8:
                self.count -= 8
                pos = self.pos
                byte = self.data[pos] if pos < len(self.data) else 0
                self.value |= byte << self.count
                self.pos = pos + 1
        return out

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v

    def signed(self, n: int) -> int:
        v = self.literal(n)
        return -v if self.bit(128) else v

    def optional_signed(self, n: int) -> int:
        return self.signed(n) if self.bit(128) else 0

    def check(self) -> None:
        """libwebp refuses a partition read past its end (it feeds zeros
        and flags it)."""
        if self.pos > len(self.data) + 2:
            raise _refused(self.path, "truncated partition")


def _coeffs(br: _Bool, bands: list, ctx: int, dq: tuple, first: int, out: list) -> int:
    """``vp8_dec.c::GetCoeffs``: one block's tokens into ``out`` (natural
    order, dequantised); returns the position after the last non-zero one."""
    bit = br.bit
    n = first
    p = bands[n][ctx]
    while n < 16:
        if not bit(p[0]):
            return n  # end of block
        while not bit(p[1]):  # a zero
            n += 1
            if n == 16:
                return 16
            p = bands[n][0]
        if not bit(p[2]):
            v, nxt = 1, 1
        else:
            nxt = 2
            if not bit(p[3]):
                v = 2 if not bit(p[4]) else 3 + bit(p[5])
            elif not bit(p[6]):
                if not bit(p[7]):
                    v = 5 + bit(159)
                else:
                    v = 7 + 2 * bit(165)
                    v += bit(145)
            else:
                b1 = bit(p[8])
                b0 = bit(p[9 + b1])
                cat = 2 * b1 + b0
                v = 0
                for prob in CAT3456[cat]:
                    v = v + v + bit(prob)
                v += 3 + (8 << cat)
        if bit(128):
            v = -v
        out[ZIGZAG[n]] = v * dq[n > 0]
        n += 1
        if n < 16:
            p = bands[n][nxt]
    return 16


def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def _idct(c: np.ndarray) -> np.ndarray:
    """``dsp/dec.c::TransformOne`` on ``[n, 16]`` int64 coefficients ->
    ``[n, 4, 4]`` residuals (``>> 3``, before the clip)."""
    tmp = np.empty_like(c)
    for i in range(4):  # vertical pass
        a = c[:, i] + c[:, 8 + i]
        b = c[:, i] - c[:, 8 + i]
        cc = _mul2(c[:, 4 + i]) - _mul1(c[:, 12 + i])
        d = _mul1(c[:, 4 + i]) + _mul2(c[:, 12 + i])
        tmp[:, 4 * i:4 * i + 4] = np.stack([a + d, b + cc, b - cc, a - d], 1)
    out = np.empty((len(c), 4, 4), np.int64)
    for i in range(4):  # horizontal pass: output row i
        dc = tmp[:, i] + 4
        a = dc + tmp[:, 8 + i]
        b = dc - tmp[:, 8 + i]
        cc = _mul2(tmp[:, 4 + i]) - _mul1(tmp[:, 12 + i])
        d = _mul1(tmp[:, 4 + i]) + _mul2(tmp[:, 12 + i])
        out[:, i] = np.stack([a + d, b + cc, b - cc, a - d], 1) >> 3
    return out


def _iwht(c: np.ndarray) -> np.ndarray:
    """``dsp/dec.c::TransformWHT``: ``[n, 16]`` second-order coefficients ->
    ``[n, 16]`` DC values of the 16 luma blocks (raster order)."""
    tmp = np.empty_like(c)
    for i in range(4):
        a0, a1 = c[:, i] + c[:, 12 + i], c[:, 4 + i] + c[:, 8 + i]
        a2, a3 = c[:, 4 + i] - c[:, 8 + i], c[:, i] - c[:, 12 + i]
        tmp[:, i], tmp[:, 8 + i] = a0 + a1, a0 - a1
        tmp[:, 4 + i], tmp[:, 12 + i] = a3 + a2, a3 - a2
    out = np.empty_like(c)
    for i in range(4):
        dc = tmp[:, 4 * i] + 3
        a0, a1 = dc + tmp[:, 4 * i + 3], tmp[:, 4 * i + 1] + tmp[:, 4 * i + 2]
        a2, a3 = tmp[:, 4 * i + 1] - tmp[:, 4 * i + 2], dc - tmp[:, 4 * i + 3]
        out[:, 4 * i] = (a0 + a1) >> 3
        out[:, 4 * i + 1] = (a3 + a2) >> 3
        out[:, 4 * i + 2] = (a0 - a1) >> 3
        out[:, 4 * i + 3] = (a3 - a2) >> 3
    return out


def _qindex(q: int, top: int = 127) -> int:
    return min(max(q, 0), top)


class _Header:
    """The key frame's header from the first partition (``VP8GetHeaders``)."""

    def __init__(self, br: _Bool, data: bytes, parts_at: int, path: str):
        br.bit(128)  # colour space
        br.bit(128)  # clamping type: libwebp always clamps
        self.segments = br.bit(128)
        self.update_map, self.absolute = 0, 0
        self.seg_quant, self.seg_filter, self.seg_probs = [0] * 4, [0] * 4, [255] * 3
        if self.segments:
            self.update_map = br.bit(128)
            if br.bit(128):  # update the segment data
                self.absolute = br.bit(128)
                self.seg_quant = [br.optional_signed(7) for _ in range(4)]
                self.seg_filter = [br.optional_signed(6) for _ in range(4)]
            if self.update_map:
                self.seg_probs = [br.literal(8) if br.bit(128) else 255 for _ in range(3)]
        self.simple = br.bit(128)
        self.level = br.literal(6)
        self.sharpness = br.literal(3)
        self.ref_delta, self.mode_delta = 0, 0
        if br.bit(128):  # loop filter deltas in use
            ref, mode = [0] * 4, [0] * 4
            if br.bit(128):  # ... and updated
                ref = [br.signed(6) if br.bit(128) else 0 for _ in range(4)]
                mode = [br.signed(6) if br.bit(128) else 0 for _ in range(4)]
            self.ref_delta, self.mode_delta = ref[0], mode[0]
        self.use_deltas = self.ref_delta or self.mode_delta
        last = (1 << br.literal(2)) - 1
        sizes = data[parts_at:parts_at + 3 * last]
        if len(sizes) < 3 * last:
            raise _refused(path, "truncated partition sizes")
        at, self.parts = parts_at + 3 * last, []
        for p in range(last):
            size = min(int.from_bytes(sizes[3 * p:3 * p + 3], "little"), max(0, len(data) - at))
            self.parts.append(_Bool(data[at:at + size], path))
            at += size
        self.parts.append(_Bool(data[at:], path))
        base = br.literal(7)
        dy1_dc, dy2_dc, dy2_ac, duv_dc, duv_ac = (br.optional_signed(4) for _ in range(5))
        self.quant = []
        for s in range(4):
            q = (self.seg_quant[s] + (0 if self.absolute else base)) if self.segments else base
            y2_ac = max(8, (AC_TABLE[_qindex(q + dy2_ac)] * 101581) >> 16)  # x 155 / 100
            self.quant.append(((DC_TABLE[_qindex(q + dy1_dc)], AC_TABLE[_qindex(q)]),
                               (DC_TABLE[_qindex(q + dy2_dc)] * 2, y2_ac),
                               (DC_TABLE[_qindex(q + duv_dc, 117)], AC_TABLE[_qindex(q + duv_ac)])))
        br.bit(128)  # refresh the entropy probabilities: one frame, no matter
        probs = [[[list(COEFFS_PROBA0[((t * 8 + b) * 3 + c) * 11:((t * 8 + b) * 3 + c) * 11 + 11])
                   for c in range(3)] for b in range(8)] for t in range(4)]
        for t in range(4):
            for b in range(8):
                for c in range(3):
                    for p in range(11):
                        if br.bit(COEFFS_UPDATE_PROBA[((t * 8 + b) * 3 + c) * 11 + p]):
                            probs[t][b][c][p] = br.literal(8)
        # per type, the probabilities of each coefficient position
        self.bands = [[probs[t][BANDS[n]] for n in range(17)] for t in range(4)]
        self.skip_prob = br.literal(8) if br.bit(128) else None


def _filter_strengths(hdr: _Header) -> list:
    """``frame_dec.c::PrecomputeFilterStrengths``: per segment and per
    (16x16, 4x4) luma mode, (level, interior limit, hev threshold)."""
    out = []
    for s in range(4):
        base = hdr.level
        if hdr.segments:
            base = hdr.seg_filter[s] + (0 if hdr.absolute else hdr.level)
        row = []
        for i4x4 in (0, 1):
            level = base
            if hdr.use_deltas:
                level += hdr.ref_delta + (hdr.mode_delta if i4x4 else 0)
            level = min(max(level, 0), 63)
            ilevel = level
            if hdr.sharpness:
                ilevel >>= 2 if hdr.sharpness > 4 else 1
                ilevel = min(ilevel, 9 - hdr.sharpness)
            ilevel = max(ilevel, 1)
            row.append((level, ilevel, 2 if level >= 40 else 1 if level >= 15 else 0))
        out.append(row)
    return out


class _MB:
    __slots__ = ("segment", "skip", "i4x4", "ymodes", "uvmode", "coeffs", "nonzero")


def sub_block_mode(br: _Bool, prob) -> int:
    """One 4x4 sub-block mode by the tree ``YMODES_INTRA4`` under ``prob``."""
    i = YMODES_INTRA4[br.bit(prob[0])]
    while i > 0:
        i = YMODES_INTRA4[2 * i + br.bit(prob[i])]
    return -i


def key_frame_modes(br: _Bool, mb, intra_top: list, intra_left: list, mb_x: int) -> None:
    """``tree_dec.c::ParseIntraMode``: a key frame macroblock's luma modes
    (``mb.i4x4``, ``mb.ymodes``) and chroma mode (``mb.uvmode``); the
    sub-block modes' contexts are the modes above (``intra_top``) and to the
    left (``intra_left``), which this updates."""
    mb.i4x4 = not br.bit(145)
    if not mb.i4x4:
        mode = ((TM_PRED if br.bit(128) else H_PRED) if br.bit(156)
                else (V_PRED if br.bit(163) else DC_PRED))
        mb.ymodes = [mode]
        intra_top[4 * mb_x:4 * mb_x + 4] = [mode] * 4
        intra_left[:] = [mode] * 4
    else:
        modes = []
        for y in range(4):
            ymode = intra_left[y]
            for x in range(4):
                ymode = sub_block_mode(br, BMODES_PROBA[(intra_top[4 * mb_x + x] * 10 + ymode) * 9:])
                intra_top[4 * mb_x + x] = ymode
                modes.append(ymode)
            intra_left[y] = ymode
        mb.ymodes = modes
    mb.uvmode = (DC_PRED if not br.bit(142) else V_PRED if not br.bit(114)
                 else TM_PRED if br.bit(183) else H_PRED)


def _parse(data: bytes, path: str):
    """Every macroblock's modes and dequantised coefficients."""
    if len(data) < 10:
        raise _refused(path, "truncated frame header")
    tag = int.from_bytes(data[:3], "little")
    if tag & 1:
        raise _refused(path, "inter frame")
    if (tag >> 1) & 7 > 3:
        raise _refused(path, f"profile {(tag >> 1) & 7}")
    if not (tag >> 4) & 1:
        raise _refused(path, "frame that is not shown")
    if data[3:6] != b"\x9d\x01\x2a":
        raise _refused(path, "key frame without its start code")
    width = int.from_bytes(data[6:8], "little") & 0x3FFF
    height = int.from_bytes(data[8:10], "little") & 0x3FFF
    first = tag >> 5
    if width == 0 or height == 0 or 10 + first > len(data):
        raise _refused(path, "bad frame size or partition length")
    br = _Bool(data[10:10 + first], path)
    hdr = _Header(br, data, 10 + first, path)
    mb_w, mb_h = (width + 15) >> 4, (height + 15) >> 4
    intra_top = [B_DC] * (4 * mb_w)
    nz_top = [0] * mb_w  # libwebp's nz_ bits: 4 luma columns, then 2 + 2 chroma
    nz_dc_top = [0] * mb_w
    mbs = []
    for mb_y in range(mb_h):
        intra_left = [B_DC] * 4
        row = []
        for mb_x in range(mb_w):  # the row's modes, from the first partition
            mb = _MB()
            if hdr.update_map:
                probs = hdr.seg_probs
                mb.segment = (br.bit(probs[1]) if not br.bit(probs[0])
                              else br.bit(probs[2]) + 2)
            else:
                mb.segment = 0
            mb.skip = br.bit(hdr.skip_prob) if hdr.skip_prob is not None else 0
            key_frame_modes(br, mb, intra_top, intra_left, mb_x)
            row.append(mb)
        br.check()
        tokens = hdr.parts[mb_y & (len(hdr.parts) - 1)]
        nz_left, nz_dc_left = 0, 0
        for mb_x, mb in enumerate(row):  # the row's tokens
            coeffs = [0] * 400  # 16 luma, 4 + 4 chroma, then the second-order block
            q_y1, q_y2, q_uv = hdr.quant[mb.segment]
            if mb.skip:
                nz_left = nz_top[mb_x] = 0
                if not mb.i4x4:
                    nz_dc_left = nz_dc_top[mb_x] = 0
                mb.nonzero = False
            else:
                y_nz, uv_nz, nz_left, nz_dc_left = residuals(
                    tokens, hdr.bands, not mb.i4x4, coeffs, nz_top, nz_dc_top, mb_x, nz_left,
                    nz_dc_left, q_y1, q_y2, q_uv)
                mb.nonzero = y_nz or uv_nz
            mb.coeffs = coeffs
            tokens.check()
        mbs.append(row)
    return hdr, width, height, mbs


def residuals(br, bands, has_y2, out, nz_top, nz_dc_top, mb_x, nz_left, nz_dc_left, q_y1, q_y2,
              q_uv):
    """``vp8_dec.c::ParseResiduals`` for one macroblock, with a second-order
    block when ``has_y2``; returns (a luma block has coefficients past its
    first, a chroma block has any, the left contexts, the left DC context)."""
    block = [0] * 16
    if has_y2:  # the second-order DC block
        nz = _coeffs(br, bands[1], nz_dc_top[mb_x] + nz_dc_left, q_y2, 0, block)
        nz_dc_top[mb_x] = nz_dc_left = int(nz > 0)
        out[384:400] = block
        first, ac = 1, bands[0]
    else:
        first, ac = 0, bands[3]
    y_nz = uv_nz = False
    tnz, lnz = nz_top[mb_x] & 15, nz_left & 15
    for y in range(4):
        left = lnz & 1
        for x in range(4):
            block = [0] * 16
            nz = _coeffs(br, ac, left + (tnz & 1), q_y1, first, block)
            left = int(nz > first)
            y_nz = y_nz or nz > first
            tnz = (tnz >> 1) | (left << 7)
            out[16 * (4 * y + x):16 * (4 * y + x) + 16] = block
        tnz >>= 4
        lnz = (lnz >> 1) | (left << 7)
    out_t, out_l = tnz, lnz >> 4
    for ch in (0, 2):
        tnz, lnz = nz_top[mb_x] >> (4 + ch), nz_left >> (4 + ch)
        for y in range(2):
            left = lnz & 1
            for x in range(2):
                block = [0] * 16
                nz = _coeffs(br, bands[2], left + (tnz & 1), q_uv, 0, block)
                left = int(nz > 0)
                uv_nz = uv_nz or nz > 0
                tnz = (tnz >> 1) | (left << 3)
                at = 256 + 32 * ch + 16 * (2 * y + x)
                out[at:at + 16] = block
            tnz >>= 2
            lnz = (lnz >> 1) | (left << 5)
        out_t |= (tnz << 4) << ch
        out_l |= (lnz & 0xF0) << ch
    nz_top[mb_x] = out_t
    return y_nz, uv_nz, out_l, nz_dc_left


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _dc_mode(mode: int, mb_x: int, mb_y: int) -> str | int:
    """``frame_dec.c::CheckMode``: DC prediction without the missing edges."""
    if mode != DC_PRED:
        return mode
    return ("none" if mb_y == 0 else "left") if mb_x == 0 else ("top" if mb_y == 0 else "both")


def _pred_block(mode, top: np.ndarray, left: np.ndarray, tl: int, size: int) -> np.ndarray:
    """16x16 luma or 8x8 chroma prediction; ``mode`` after ``_dc_mode``."""
    shift = size.bit_length() - 1  # 4 or 3
    if mode == "both":
        return np.full((size, size), (int(top.sum()) + int(left.sum()) + size) >> (shift + 1))
    if mode == "top":  # no row above: the left column only
        return np.full((size, size), (int(left.sum()) + (size >> 1)) >> shift)
    if mode == "left":  # no column to the left: the row above only
        return np.full((size, size), (int(top.sum()) + (size >> 1)) >> shift)
    if mode == "none":
        return np.full((size, size), 128)
    if mode == V_PRED:
        return np.broadcast_to(top, (size, size))
    if mode == H_PRED:
        return np.broadcast_to(left[:, None], (size, size))
    return np.clip(top[None, :] + left[:, None] - tl, 0, 255)  # TM_PRED


def _pred4(mode: int, top: list, left: list, tl: int) -> np.ndarray:
    """``dsp/dec.c``'s 4x4 predictors; ``top`` holds 8 pixels (4 above, 4
    above-right), ``left`` 4."""
    A, B, C, D, E, F, G, H = top
    I, J, K, L = left
    X = tl
    if mode == B_DC:
        return np.full((4, 4), (sum(top[:4]) + sum(left) + 4) >> 3)
    if mode == B_TM:
        return np.clip(np.array(top[:4])[None, :] + np.array(left)[:, None] - X, 0, 255)
    if mode == B_VE:
        return np.broadcast_to(np.array([_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D),
                                         _avg3(C, D, E)]), (4, 4))
    if mode == B_HE:
        return np.broadcast_to(np.array([_avg3(X, I, J), _avg3(I, J, K), _avg3(J, K, L),
                                         _avg3(K, L, L)])[:, None], (4, 4))
    d = {}  # (x, y) -> value
    if mode == B_RD:
        d[0, 3] = _avg3(J, K, L)
        d[1, 3] = d[0, 2] = _avg3(I, J, K)
        d[2, 3] = d[1, 2] = d[0, 1] = _avg3(X, I, J)
        d[3, 3] = d[2, 2] = d[1, 1] = d[0, 0] = _avg3(A, X, I)
        d[3, 2] = d[2, 1] = d[1, 0] = _avg3(B, A, X)
        d[3, 1] = d[2, 0] = _avg3(C, B, A)
        d[3, 0] = _avg3(D, C, B)
    elif mode == B_LD:
        d[0, 0] = _avg3(A, B, C)
        d[1, 0] = d[0, 1] = _avg3(B, C, D)
        d[2, 0] = d[1, 1] = d[0, 2] = _avg3(C, D, E)
        d[3, 0] = d[2, 1] = d[1, 2] = d[0, 3] = _avg3(D, E, F)
        d[3, 1] = d[2, 2] = d[1, 3] = _avg3(E, F, G)
        d[3, 2] = d[2, 3] = _avg3(F, G, H)
        d[3, 3] = _avg3(G, H, H)
    elif mode == B_VR:
        d[0, 0] = d[1, 2] = _avg2(X, A)
        d[1, 0] = d[2, 2] = _avg2(A, B)
        d[2, 0] = d[3, 2] = _avg2(B, C)
        d[3, 0] = _avg2(C, D)
        d[0, 3] = _avg3(K, J, I)
        d[0, 2] = _avg3(J, I, X)
        d[0, 1] = d[1, 3] = _avg3(I, X, A)
        d[1, 1] = d[2, 3] = _avg3(X, A, B)
        d[2, 1] = d[3, 3] = _avg3(A, B, C)
        d[3, 1] = _avg3(B, C, D)
    elif mode == B_VL:
        d[0, 0] = _avg2(A, B)
        d[1, 0] = d[0, 2] = _avg2(B, C)
        d[2, 0] = d[1, 2] = _avg2(C, D)
        d[3, 0] = d[2, 2] = _avg2(D, E)
        d[0, 1] = _avg3(A, B, C)
        d[1, 1] = d[0, 3] = _avg3(B, C, D)
        d[2, 1] = d[1, 3] = _avg3(C, D, E)
        d[3, 1] = d[2, 3] = _avg3(D, E, F)
        d[3, 2] = _avg3(E, F, G)
        d[3, 3] = _avg3(F, G, H)
    elif mode == B_HU:
        d[0, 0] = _avg2(I, J)
        d[2, 0] = d[0, 1] = _avg2(J, K)
        d[2, 1] = d[0, 2] = _avg2(K, L)
        d[1, 0] = _avg3(I, J, K)
        d[3, 0] = d[1, 1] = _avg3(J, K, L)
        d[3, 1] = d[1, 2] = _avg3(K, L, L)
        d[3, 2] = d[2, 2] = d[0, 3] = d[1, 3] = d[2, 3] = d[3, 3] = L
    else:  # B_HD
        d[0, 0] = d[2, 1] = _avg2(I, X)
        d[0, 1] = d[2, 2] = _avg2(J, I)
        d[0, 2] = d[2, 3] = _avg2(K, J)
        d[0, 3] = _avg2(L, K)
        d[3, 0] = _avg3(A, B, C)
        d[2, 0] = _avg3(X, A, B)
        d[1, 0] = d[3, 1] = _avg3(I, X, A)
        d[1, 1] = d[3, 2] = _avg3(J, I, X)
        d[1, 2] = d[3, 3] = _avg3(K, J, I)
        d[1, 3] = _avg3(L, K, J)
    out = np.empty((4, 4), np.int64)
    for (x, y), v in d.items():
        out[y, x] = v
    return out


def _reconstruct(mbs: list, mb_w: int, mb_h: int, residual: np.ndarray):
    """Intra prediction plus residuals, macroblock by macroblock, into
    planes with libwebp's borders: row 0 above the frame (127), column 0 to
    its left (129); the luma plane has 4 more columns for the pixels
    above-right of the last macroblock of the first row."""
    y_pl = np.zeros((16 * mb_h + 1, 16 * mb_w + 5), np.int64)
    uv_pl = [np.zeros((8 * mb_h + 1, 8 * mb_w + 1), np.int64) for _ in range(2)]
    for plane in (y_pl, *uv_pl):
        plane[0], plane[1:, 0] = 127, 129
    for mb_y in range(mb_h):
        for mb_x in range(mb_w):
            intra_mb(y_pl, uv_pl, mbs[mb_y][mb_x], mb_x, mb_y, mb_w,
                     residual[mb_y * mb_w + mb_x])
    return y_pl[1:, 1:16 * mb_w + 1], uv_pl[0][1:, 1:], uv_pl[1][1:, 1:]


def intra_mb(y_pl: np.ndarray, uv_pl: list, mb, mb_x: int, mb_y: int, mb_w: int,
             res: np.ndarray) -> None:
    """One macroblock's intra prediction plus its residuals (``[24, 4, 4]``)
    into planes laid out as ``_reconstruct`` lays them out."""
    y0, x0 = 16 * mb_y + 1, 16 * mb_x + 1
    if not mb.i4x4:
        mode = _dc_mode(mb.ymodes[0], mb_x, mb_y)
        pred = _pred_block(mode, y_pl[y0 - 1, x0:x0 + 16], y_pl[y0:y0 + 16, x0 - 1],
                           int(y_pl[y0 - 1, x0 - 1]), 16)
        blocks = res[:16].reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 16)
        y_pl[y0:y0 + 16, x0:x0 + 16] = np.clip(pred + blocks, 0, 255)
    else:
        # above-right of the macroblock: the next one's top row, the pixel
        # above this one's last column repeated at the right edge, 127 atop
        if mb_y == 0:
            top_right = [127] * 4
        elif mb_x == mb_w - 1:
            top_right = [int(y_pl[y0 - 1, x0 + 15])] * 4
        else:
            top_right = y_pl[y0 - 1, x0 + 16:x0 + 20].tolist()
        for n in range(16):
            by, bx = y0 + 4 * (n >> 2), x0 + 4 * (n & 3)
            above = y_pl[by - 1, bx:bx + 4].tolist()
            if (n & 3) == 3:
                right = top_right
            else:
                right = y_pl[by - 1, bx + 4:bx + 8].tolist()
            if n < 4 and (n & 3) < 3 and mb_y == 0:
                right = [127] * 4
            pred = _pred4(mb.ymodes[n], above + right, y_pl[by:by + 4, bx - 1].tolist(),
                          int(y_pl[by - 1, bx - 1]))
            y_pl[by:by + 4, bx:bx + 4] = np.clip(pred + res[n], 0, 255)
    mode = _dc_mode(mb.uvmode, mb_x, mb_y)
    c0, r0 = 8 * mb_x + 1, 8 * mb_y + 1
    for k, plane in enumerate(uv_pl):
        pred = _pred_block(mode, plane[r0 - 1, c0:c0 + 8], plane[r0:r0 + 8, c0 - 1],
                           int(plane[r0 - 1, c0 - 1]), 8)
        blocks = res[16 + 4 * k:20 + 4 * k].reshape(2, 2, 4, 4).transpose(
            0, 2, 1, 3).reshape(8, 8)
        plane[r0:r0 + 8, c0:c0 + 8] = np.clip(pred + blocks, 0, 255)


def _filter(px: np.ndarray, limit: np.ndarray, inner_limit: np.ndarray, hev_thresh: np.ndarray,
            kind: str) -> None:
    """The loop filter, in place, on ``[8, N]`` lines across an edge (rows
    p3 p2 p1 p0 q0 q1 q2 q3) with each line's limits ``[N]``; ``kind`` is
    ``"simple"`` (``DoFilter2`` where ``NeedsFilter``), ``"mb"`` (a
    macroblock edge, ``FilterLoop26``) or ``"inner"`` (``FilterLoop24``),
    with FFmpeg's ``vp8dsp.c`` clamps, which give libwebp's values."""
    p3, p2, p1, p0, q0, q1, q2, q3 = px
    mask = 2 * np.abs(p0 - q0) + (np.abs(p1 - q1) >> 1) <= limit
    if kind == "simple":
        common, rest = np.flatnonzero(mask), None
    else:
        edge = np.maximum(np.abs(p1 - p0), np.abs(q1 - q0))
        interior = np.maximum.reduce([np.abs(p3 - p2), np.abs(p2 - p1), np.abs(q3 - q2),
                                      np.abs(q2 - q1), edge])
        mask &= interior <= inner_limit
        hev = edge > hev_thresh
        common, rest = np.flatnonzero(mask & hev), np.flatnonzero(mask & ~hev)
    if len(common):
        c = px[:, common]
        a = _s8(3 * (c[4] - c[3]) + _s8(c[2] - c[5]))
        px[3, common] = _u8(c[3] + (np.minimum(a + 3, 127) >> 3))
        px[4, common] = _u8(c[4] - (np.minimum(a + 4, 127) >> 3))
    if rest is None or not len(rest):
        return
    r = px[:, rest]
    if kind == "mb":
        w = _s8(_s8(r[2] - r[5]) + 3 * (r[4] - r[3]))
        a0, a1, a2 = (27 * w + 63) >> 7, (18 * w + 63) >> 7, (9 * w + 63) >> 7
        px[1:7, rest] = _u8(r[1:7] + np.stack([a2, a1, a0, -a0, -a1, -a2]))
    else:
        a = _s8(3 * (r[4] - r[3]))
        f1, f2 = np.minimum(a + 4, 127) >> 3, np.minimum(a + 3, 127) >> 3
        a3 = (f1 + 1) >> 1
        px[2:6, rest] = _u8(r[2:6] + np.stack([a3, f2, -f1, -a3]))


def _s8(x: np.ndarray) -> np.ndarray:
    return np.minimum(np.maximum(x, -128), 127)


def _u8(x: np.ndarray) -> np.ndarray:
    return np.minimum(np.maximum(x, 0), 255)


# the order of a macroblock's edges in each plane: (vertical or horizontal,
# offset, a macroblock edge); chroma's four are at the luma steps' places
LUMA_STEPS = [("v", 0, True), ("v", 4, False), ("v", 8, False), ("v", 12, False),
              ("h", 0, True), ("h", 4, False), ("h", 8, False), ("h", 12, False)]
CHROMA_STEPS = {0: ("v", 0, True), 1: ("v", 4, False), 4: ("h", 0, True), 5: ("h", 4, False)}


def _template(size: int, stride: int, way: str, d: int) -> np.ndarray:
    """The flat offsets, from a block's first pixel, of the 8 pixels across
    its edge at offset ``d`` on each of its ``size`` lines: ``[8, size]``."""
    across, span = np.arange(-4, 4)[:, None] + d, np.arange(size)[None, :]
    return span * stride + across if way == "v" else across * stride + span


def loop_filter(planes: list, level: np.ndarray, inner_limit: np.ndarray, hev: np.ndarray,
                inner: np.ndarray, simple: bool) -> None:
    """``frame_dec.c::DoFilter`` / ``vp8.c::filter_mb`` (luma only for the
    simple filter) over every macroblock of the grid planes (int32,
    filtered in place): per macroblock and plane the left edge, the inner
    vertical edges, the top edge, the inner horizontal ones, with each
    macroblock's ``level`` (none at 0), ``inner_limit`` and ``hev``
    threshold, the inner edges where ``inner``. A macroblock ``(x, y)``
    touches pixels that ``(x - 1, y)`` and ``(x + 1, y - 1)`` touch and none
    that another macroblock of its wavefront ``x + 2 y`` touches, so the
    wavefronts in order give raster order's result; each step of a
    wavefront filters its luma edges and the chroma ones at the same place
    of the order at once, from one buffer of the three planes (both chroma
    planes side by side). ``level`` etc. are ``[mb_h, mb_w]``."""
    mb_h, mb_w = level.shape
    y_stride, cw = planes[0].shape[1], planes[1].shape[1]
    parts = [planes[0].reshape(-1)]
    if not simple:
        parts.append(np.concatenate([planes[1], planes[2]], axis=1).reshape(-1))
    buf = np.concatenate(parts)
    c_at, c_stride = planes[0].size, 2 * cw
    y_tpl = [_template(16, y_stride, way, d) for way, d, _ in LUMA_STEPS]
    c_tpl = {k: _template(8, c_stride, way, d) for k, (way, d, _) in CHROMA_STEPS.items()}
    kinds = {True: "simple" if simple else "mb", False: "simple" if simple else "inner"}
    for t in range(mb_w + 2 * (mb_h - 1)):
        ys = np.arange(max(0, (t - mb_w + 2) // 2), min(mb_h - 1, t // 2) + 1)
        xs = t - 2 * ys
        keep = level[ys, xs] > 0
        ys, xs = ys[keep], xs[keep]
        if not len(ys):
            continue
        lv, il, hv = level[ys, xs], inner_limit[ys, xs], hev[ys, xs]
        params = {True: np.stack([2 * lv + il + 4, il, hv]), False: np.stack([2 * lv + il, il, hv])}
        edge_on = {"v": xs > 0, "h": ys > 0}
        inn = inner[ys, xs]
        y_base = 16 * ys * y_stride + 16 * xs
        c_base = c_at + 8 * ys * c_stride + 8 * xs
        for k, (way, d, mb_edge) in enumerate(LUMA_STEPS):
            on = edge_on[way] if mb_edge else inn
            if not on.any():
                continue
            idx = (y_tpl[k][:, None, :] + y_base[on, None]).reshape(8, -1)
            par = np.repeat(params[mb_edge][:, on], 16, axis=1)
            if not simple and k in CHROMA_STEPS:
                base = np.concatenate([c_base[on], c_base[on] + cw])
                idx = np.concatenate([idx, (c_tpl[k][:, None, :] + base[:, None]).reshape(8, -1)],
                                     axis=1)
                par = np.concatenate([par, np.repeat(np.tile(params[mb_edge][:, on], 2), 8,
                                                     axis=1)], axis=1)
            px = buf[idx]
            _filter(px, par[0], par[1], par[2], kinds[mb_edge])
            buf[idx] = px
    planes[0][:] = buf[:c_at].reshape(planes[0].shape)
    if not simple:
        chroma = buf[c_at:].reshape(-1, c_stride)
        planes[1][:], planes[2][:] = chroma[:, :cw], chroma[:, cw:]


def _fancy(top: np.ndarray, cur: np.ndarray, width: int):
    """``upsampling.c::UpsampleRgbLinePair``'s chroma for one pair of output
    rows: ``top`` and ``cur`` are the chroma rows above and below them
    (``[..., cw]``); returns the samples of the upper and the lower row."""
    up = np.empty(top.shape[:-1] + (width,), np.int64)
    down = np.empty_like(up)
    up[..., 0] = (3 * top[..., 0] + cur[..., 0] + 2) >> 2
    down[..., 0] = (3 * cur[..., 0] + top[..., 0] + 2) >> 2
    last = (width - 1) >> 1
    if last:
        tl, t = top[..., :last], top[..., 1:last + 1]
        lf, c = cur[..., :last], cur[..., 1:last + 1]
        avg = tl + t + lf + c + 8
        d12, d03 = (avg + 2 * (t + lf)) >> 3, (avg + 2 * (tl + c)) >> 3
        up[..., 1:2 * last:2], up[..., 2:2 * last + 1:2] = (d12 + tl) >> 1, (d03 + t) >> 1
        down[..., 1:2 * last:2], down[..., 2:2 * last + 1:2] = (d03 + lf) >> 1, (d12 + c) >> 1
    if width % 2 == 0:
        up[..., -1] = (3 * top[..., last] + cur[..., last] + 2) >> 2
        down[..., -1] = (3 * cur[..., last] + top[..., last] + 2) >> 2
    return up, down


def _upsample(plane: np.ndarray, height: int, width: int) -> np.ndarray:
    """``io_dec.c::EmitFancyRGB``'s full-resolution chroma: the first row
    from chroma row 0 alone, rows ``2k - 1, 2k`` from chroma rows ``k - 1, k``,
    and an even height's last row from the last chroma row alone."""
    out = np.empty((height, width), np.int64)
    out[0] = _fancy(plane[0], plane[0], width)[0]
    pairs = (height - 1) // 2
    if pairs:
        up, down = _fancy(plane[:pairs], plane[1:pairs + 1], width)
        out[1:2 * pairs:2], out[2:2 * pairs + 1:2] = up, down
    if height % 2 == 0 and height > 1:
        last = plane[height // 2 - 1]
        out[-1] = _fancy(last, last, width)[0]
    return out


def _clip8(v: np.ndarray) -> np.ndarray:
    """``yuv.h::VP8Clip8``: 14-bit fixed point to 8 bits, saturated."""
    return np.where((v & ~16383) == 0, v >> 6, np.where(v < 0, 0, 255))


def yuv_to_bgr(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """``yuv.h::VP8YuvToBgr`` on whole planes (int64, same shape)."""
    yy = (y * 19077) >> 8
    out = np.empty(y.shape + (3,), np.uint8)
    out[..., 0] = _clip8(yy + ((u * 33050) >> 8) - 17685)
    out[..., 1] = _clip8(yy - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708)
    out[..., 2] = _clip8(yy + ((v * 26149) >> 8) - 14234)
    return out


def decode_vp8_planes(data: bytes, path: str = "<bytes>"):
    """A ``VP8 `` chunk's payload -> its Y, U and V planes (int64, cropped to
    the frame: ``[H, W]``, ``[(H + 1) / 2, (W + 1) / 2]``) after the loop
    filter."""
    hdr, width, height, mbs = _parse(data, path)
    mb_w, mb_h = (width + 15) >> 4, (height + 15) >> 4
    flat = [mb for row in mbs for mb in row]
    coeffs = np.array([mb.coeffs for mb in flat], np.int64)  # [n, 400]
    i16 = np.array([not mb.i4x4 for mb in flat])
    dc = np.zeros((len(flat), 16), np.int64)
    if i16.any():
        dc[i16] = _iwht(coeffs[i16, 384:400])
        coeffs[i16, 0:256:16] = dc[i16]
    residual = _idct(coeffs[:, :384].reshape(-1, 16)).reshape(len(flat), 24, 4, 4)
    # inner edges are filtered where the macroblock is 4x4-predicted or has
    # non-zero coefficients (the second-order block counts through its DCs)
    inner = np.array([mb.i4x4 or mb.nonzero or bool(dc[i].any())
                      for i, mb in enumerate(flat)]).reshape(mb_h, mb_w)
    planes = [np.ascontiguousarray(p, np.int32) for p in _reconstruct(mbs, mb_w, mb_h, residual)]
    if hdr.level:
        strengths = _filter_strengths(hdr)
        per_mb = np.array([strengths[mb.segment][int(mb.i4x4)] for mb in flat]).reshape(
            mb_h, mb_w, 3)
        loop_filter(planes, per_mb[..., 0], per_mb[..., 1], per_mb[..., 2], inner,
                    bool(hdr.simple))
    y_pl, u_pl, v_pl = (p.astype(np.int64) for p in planes)
    cw, ch = (width + 1) // 2, (height + 1) // 2
    return y_pl[:height, :width], u_pl[:ch, :cw], v_pl[:ch, :cw]


def decode_vp8_bgr(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """A ``VP8 `` chunk's payload -> ``[H, W, 3]`` uint8 BGR as
    ``WebPDecodeBGRInto`` gives it (fancy upsampling, ``VP8YuvToBgr``)."""
    y, u, v = decode_vp8_planes(data, path)
    h, w = y.shape
    return yuv_to_bgr(y, _upsample(u, h, w), _upsample(v, h, w))
