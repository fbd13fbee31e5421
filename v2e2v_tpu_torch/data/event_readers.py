"""Event file readers, host side (port of ``v2e2v_tpu/data/event_readers.py``).

``RefTimeEventReader`` loads a whole ``[t x y p]`` table (.txt/.csv/.zip),
rebases times to the first image stamp and yields the window between each
pair of consecutive image stamps; ``NpzEventReader`` yields one ``[N, 4]``
window per ``.npz`` file with ``t, x, y, p`` arrays.

Tables: ``.txt`` and ``.csv`` go to the native parser (``strtod``) when it
builds. Otherwise, and for ``.zip`` (read with ``zipfile``), the text is
parsed here in numpy, with the float conversion of pandas' C parser, which
the JAX package uses there: the same float64 stamps as that package on each
path. The two conversions differ by one ulp on some stamps of 16 or more
significant digits (``_xstrtod``).
"""

from __future__ import annotations

import zipfile
from os.path import splitext

import numpy as np

_POW10 = np.array([float(10**k) for k in range(309)])
_MAX_DIGITS = 17


def _xstrtod(tokens: np.ndarray) -> np.ndarray:
    """Decimal tokens (a bytes array) -> float64 as pandas' C parser converts
    them by default (``precise_xstrtod``): at most 17 significant digits are
    accumulated in float64 (``number = number * 10 + digit``, rounding at each
    step once past 2**53), then scaled by one multiplication or division by
    a power of ten. ``strtod`` rounds the exact decimal value once, so the
    two differ by one ulp on some tokens of 16 or more significant digits
    (e.g. ``9007.209590438957``); up to 15 they agree."""
    n, width = len(tokens), tokens.dtype.itemsize
    c = np.zeros((n, width + 1), np.uint8)
    c[:, :width] = np.frombuffer(tokens.tobytes(), np.uint8).reshape(n, width)
    rows = np.arange(n)
    pos = np.zeros(n, np.int64)
    number = np.zeros(n, np.float64)
    exponent = np.zeros(n, np.int64)
    num_digits = np.zeros(n, np.int64)

    def cur():
        return c[rows, pos]

    def digits(active):
        """Consume a run of digits where ``active``; accumulate the first 17."""
        nonlocal number
        seen = np.zeros(n, np.int64)
        decimals = np.zeros(n, np.int64)
        for _ in range(width):
            ch = cur()
            is_digit = active & (ch >= 48) & (ch <= 57)
            if not is_digit.any():
                break
            take = is_digit & (num_digits < _MAX_DIGITS)
            number = np.where(take, number * 10.0 + (ch.astype(np.float64) - 48.0), number)
            num_digits[:] += take
            decimals += take
            seen += is_digit
            pos[:] += is_digit
        return seen, decimals

    ch = cur()
    negative = ch == ord("-")
    pos += (ch == ord("-")) | (ch == ord("+"))
    int_seen, int_taken = digits(np.ones(n, bool))
    exponent += int_seen - int_taken  # integer digits past the 17th
    has_dot = cur() == ord(".")
    pos += has_dot
    dec_seen, dec_taken = digits(has_dot)
    exponent -= dec_taken
    if np.any(int_seen + dec_seen == 0):
        raise ValueError("event table: a timestamp has no digits")
    ch = cur()
    has_e = (ch == ord("e")) | (ch == ord("E"))
    if has_e.any():
        pos += has_e
        ch = cur()
        e_neg = has_e & (ch == ord("-"))
        pos += has_e & ((ch == ord("-")) | (ch == ord("+")))
        e_val = np.zeros(n, np.int64)
        e_digits = np.zeros(n, np.int64)
        for _ in range(_MAX_DIGITS):
            ch = cur()
            is_digit = has_e & (ch >= 48) & (ch <= 57)
            if not is_digit.any():
                break
            e_val = np.where(is_digit, e_val * 10 + (ch.astype(np.int64) - 48), e_val)
            e_digits += is_digit
            pos += is_digit
        exponent += np.where(e_neg, -e_val, e_val)
        pos -= has_e & (e_digits == 0)  # pandas un-reads one character: then junk
    ends = np.frombuffer(tokens.tobytes(), np.uint8).reshape(n, width) != 0
    if np.any(pos != ends.sum(1)):
        raise ValueError("event table: a timestamp is not a decimal number")

    out = number.copy()
    up = (exponent > 0) & (exponent <= 308)
    out[up] = number[up] * _POW10[exponent[up]]
    down = (exponent < 0) & (exponent >= -308)
    out[down] = number[down] / _POW10[-exponent[down]]
    sub = (exponent < -308) & (exponent >= -616)
    out[sub] = number[sub] / _POW10[-308 - exponent[sub]] / _POW10[308]
    out[exponent < -616] = 0.0
    out[exponent > 308] = np.inf
    return np.where(negative, -out, out)


def parse_events_text(data: bytes) -> np.ndarray:
    """A ``t x y p`` table's text -> float64 ``[N, 4]``: ``t`` as pandas'
    C parser converts it (``_xstrtod``), ``x y p`` as integers."""
    tokens = data.split()
    if len(tokens) % 4:
        raise ValueError(f"event table: {len(tokens)} values is not a whole number of rows")
    if not tokens:
        return np.zeros((0, 4), np.float64)
    out = np.empty((len(tokens) // 4, 4), np.float64)
    out[:, 0] = _xstrtod(np.array(tokens[0::4]))
    for col in (1, 2, 3):
        out[:, col] = np.array(tokens[col::4]).astype(np.int64)
    return out


def _zip_member(path: str) -> bytes:
    with zipfile.ZipFile(path) as zf:
        names = [n for n in zf.namelist()
                 if not n.endswith("/") and not n.startswith("__MACOSX/")]
        if len(names) != 1:
            raise ValueError(f"{path}: a zipped event table holds one file, found {names}")
        return zf.read(names[0])


def read_events_table(path: str) -> np.ndarray:
    """Load a whitespace-separated ``[t x y p]`` event table (.txt/.csv/.zip)
    as float64 ``[N, 4]``: the native parser for .txt/.csv when it builds,
    else numpy (``parse_events_text``)."""
    from .. import runtime

    ext = splitext(path)[1]
    if ext in (".txt", ".csv") and runtime.available():
        try:
            return runtime.parse_events_txt(path)
        except runtime.NativeUnavailable:
            pass  # unreadable or not a plain table: numpy says which
    if ext == ".zip":
        return parse_events_text(_zip_member(path))
    with open(path, "rb") as f:
        return parse_events_text(f.read())


class RefTimeEventReader:
    """Iterate event windows between consecutive reference image stamps.

    Event and image times are rebased by ``T_image[0]``; window ``i`` covers
    ``[T_image[i], T_image[i+1])`` (first ``>=`` positions), so events before
    the first image stamp fall in no window. The reference's quirk is kept:
    a stamp with no event at or after it points at the LAST event.
    """

    def __init__(self, path_to_event_file: str, t_image):
        if splitext(path_to_event_file)[1] not in (".txt", ".csv", ".zip"):
            raise ValueError(f"{path_to_event_file}: an event table is .txt, .csv or .zip")
        table = read_events_table(path_to_event_file)
        t_image = np.asarray(t_image, dtype=np.float64)
        self.t0 = t_image[0]
        self._events = table
        self._events[:, 0] -= self.t0

        rel_image_times = t_image - self.t0
        ts = self._events[:, 0]
        bounds = np.searchsorted(ts, rel_image_times, side="left")
        bounds = np.where(bounds >= len(ts), max(len(ts) - 1, 0), bounds)
        self._bounds = bounds.astype(np.int64)
        self._frame_id = 0

    def __iter__(self):
        return self

    def __len__(self):
        return max(len(self._bounds) - 1, 0)

    def __next__(self) -> np.ndarray:
        if self._frame_id >= len(self):
            raise StopIteration
        lo = self._bounds[self._frame_id]
        hi = self._bounds[self._frame_id + 1]
        self._frame_id += 1
        return self._events[lo:hi].copy()


class NpzEventReader:
    """Iterate per-interval ``.npz`` event files with ``t, x, y, p`` arrays."""

    def __init__(self, paths: list[str]):
        self._paths = list(paths)
        self._frame_id = 0

    def __iter__(self):
        return self

    def __len__(self):
        return len(self._paths)

    def __next__(self) -> np.ndarray:
        if self._frame_id >= len(self._paths):
            raise StopIteration
        data = np.load(self._paths[self._frame_id])
        self._frame_id += 1
        return np.stack(
            (data["t"], data["x"], data["y"], data["p"]), axis=1
        ).astype(np.float64)
