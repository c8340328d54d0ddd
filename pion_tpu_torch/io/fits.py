"""Minimal pure-Python FITS image I/O (the dataio_fits / silo2fits roles).

Counterpart of the JAX package's ``pion_tpu/io/fits.py``, writing the same
cards and images: a FITS file written by either package reads in the other
(the stored config is the reference's ``SimConfig`` dict, as in a snapshot
header).  The state may be a torch tensor on any device or a numpy array.

The reference writes one FITS image extension per primitive variable via
cfitsio (reference: source/dataIO/dataio_fits.cpp, utility.fits.class.cpp;
converter analysis/silo2fits/silo2fits.cpp).  The package needs neither
cfitsio nor astropy: FITS images are a simple container — 2880-byte header
blocks of 80-char cards plus big-endian IEEE data — so the backend is
implemented directly.  Layout mirrors the reference: a header-only primary
HDU carrying the run parameters, then one IMAGE extension per variable
named like the reference's Silo/FITS variable names (EXTNAME).

Restart parity: ``read_fits`` reconstructs ``(P, cfg, t)`` from the header
cards, so a FITS snapshot is a full restart file just like the reference's
(SURVEY.md §2.9 "every snapshot is a full restart file").
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import SimConfig
from .compare import VAR_NAMES

BLOCK = 2880


def _card(key: str, value, comment: str = "") -> bytes:
    """One 80-byte FITS header card.

    The value part must fit in 80 bytes — a card that would overflow raises
    instead of silently truncating (truncation would corrupt e.g. the stored
    config JSON with no error).  Only the optional comment may be trimmed.
    """
    if value is True or value is False:
        v = "T" if value else "F"
        body = f"{key:<8}= {v:>20}"
    elif isinstance(value, int):
        body = f"{key:<8}= {value:>20}"
    elif isinstance(value, float):
        # 17 significant digits: exact float64 round-trip
        body = f"{key:<8}= {value:>23.16E}"
    elif isinstance(value, str):
        # escape single quotes per the FITS convention
        esc = value.replace("'", "''")
        body = f"{key:<8}= '{esc:<8}'"
    else:
        raise TypeError(f"bad card value {value!r}")
    if len(body) > 80:
        raise ValueError(f"FITS card overflow for {key!r}: {len(body)} > "
                         "80 bytes")
    if comment:
        body = f"{body} / {comment}"
    return body[:80].ljust(80).encode("ascii")


def _end_pad(cards: List[bytes]) -> bytes:
    raw = b"".join(cards) + b"END" + b" " * 77
    pad = (-len(raw)) % BLOCK
    return raw + b" " * pad


def _data_pad(buf: bytes) -> bytes:
    return buf + b"\0" * ((-len(buf)) % BLOCK)


def _string_cards(key: str, text: str) -> List[bytes]:
    """Encode an arbitrarily long string as numbered chunk cards.

    Chunks are sized by *escaped* length (a single quote costs 2 chars) so a
    chunk can never overflow the 80-byte card after ``_card`` escapes it.
    A ``{key}L`` card records the total unescaped length so the
    reader can restore trailing spaces that FITS padding would otherwise eat.
    """
    chunks: List[str] = []
    cur, cur_esc = [], 0
    for ch in text:
        cost = 2 if ch == "'" else 1
        if cur_esc + cost > 60:
            chunks.append("".join(cur))
            cur, cur_esc = [], 0
        cur.append(ch)
        cur_esc += cost
    if cur or not chunks:
        chunks.append("".join(cur))
    cards = [_card(f"{key}N", len(chunks)), _card(f"{key}L", len(text))]
    for i, c in enumerate(chunks):
        cards.append(_card(f"{key}{i:03d}", c))
    return cards


def _var_names(cfg: SimConfig) -> List[str]:
    return VAR_NAMES[: cfg.eqn.nbase] + [f"Tr{i:04d}"
                                         for i in range(cfg.ntracer)]


def write_fits(path: str, P, cfg: SimConfig, t: float = 0.0,
               extra: Optional[Dict[str, float]] = None) -> str:
    """Write one image extension per variable (reference: dataio_fits.cpp
    OutputData writes one named image per variable)."""
    from .snapshot import _host_array

    P = _host_array(P)
    if not path.endswith(".fits"):
        path += ".fits"
    from .snapshot import _cfg_to_json

    names = _var_names(cfg)
    cfg_json = _cfg_to_json(cfg)
    with open(path, "wb") as f:
        # primary HDU: header only, carries the parameter registry
        cards = [
            _card("SIMPLE", True, "pion_tpu FITS snapshot"),
            _card("BITPIX", 8),
            _card("NAXIS", 0),
            _card("EXTEND", True),
            _card("SIMTIME", float(t), "simulation time"),
            _card("NVAR", int(cfg.nvar)),
            _card("NDIM", int(cfg.ndim)),
        ]
        for k, v in (extra or {}).items():
            cards.append(_card(k[:8].upper(), float(v)))
        cards += _string_cards("PCFG", cfg_json)
        f.write(_end_pad(cards))
        # one IMAGE extension per variable, float64 big-endian
        for v, name in enumerate(names):
            arr = np.ascontiguousarray(P[v], dtype=">f8")
            # FITS axes are x-fastest: NAXIS1 = last numpy axis
            shape = arr.shape[::-1]
            cards = [
                _card("XTENSION", "IMAGE"),
                _card("BITPIX", -64),
                _card("NAXIS", len(shape)),
            ]
            for i, nax in enumerate(shape):
                cards.append(_card(f"NAXIS{i + 1}", int(nax)))
            cards += [
                _card("PCOUNT", 0),
                _card("GCOUNT", 1),
                _card("EXTNAME", name),
            ]
            f.write(_end_pad(cards))
            f.write(_data_pad(arr.tobytes()))
    return path


def _parse_header(f) -> Dict[str, object]:
    """Read header blocks until END; return {key: parsed value}."""
    cards: Dict[str, object] = {}
    while True:
        block = f.read(BLOCK)
        if len(block) < BLOCK:
            raise EOFError("truncated FITS header")
        done = False
        for i in range(0, BLOCK, 80):
            card = block[i : i + 80].decode("ascii", "replace")
            key = card[:8].strip()
            if key == "END":
                done = True
                break
            if card[8:10] != "= " or not key:
                continue
            val = card[10:]
            if val.lstrip().startswith("'"):
                # scan to the closing quote honoring '' escapes; keep
                # interior trailing spaces verbatim (chunk reassembly
                # trims with the recorded length instead)
                s = val.index("'") + 1
                out = []
                while s < len(val):
                    if val[s] == "'":
                        if s + 1 < len(val) and val[s + 1] == "'":
                            out.append("'")
                            s += 2
                            continue
                        break
                    out.append(val[s])
                    s += 1
                cards[key] = "".join(out)
                continue
            if "/" in val:
                val = val.split("/")[0]
            val = val.strip()
            if val in ("T", "F"):
                cards[key] = val == "T"
            else:
                try:
                    cards[key] = int(val)
                except ValueError:
                    cards[key] = float(val)
        if done:
            return cards


def _read_string(cards: Dict[str, object], key: str) -> str:
    n = int(cards[f"{key}N"])
    text = "".join(str(cards[f"{key}{i:03d}"]) for i in range(n))
    if f"{key}L" in cards:
        # trim FITS min-8-char string padding off the final chunk
        return text[: int(cards[f"{key}L"])]
    return text.rstrip()


def read_fits(path: str) -> Tuple[np.ndarray, SimConfig, float]:
    """Read a snapshot written by :func:`write_fits` back into (P, cfg, t)."""
    from .snapshot import _cfg_from_json

    with open(path, "rb") as f:
        primary = _parse_header(f)
        cfg = _cfg_from_json(_read_string(primary, "PCFG"))
        t = float(primary.get("SIMTIME", 0.0))
        planes = {}
        while True:
            try:
                hdr = _parse_header(f)
            except EOFError:
                break
            naxis = int(hdr["NAXIS"])
            shape = tuple(int(hdr[f"NAXIS{i + 1}"])
                          for i in range(naxis))[::-1]
            bitpix = int(hdr["BITPIX"])
            dtype = {-64: ">f8", -32: ">f4"}[bitpix]
            count = int(np.prod(shape))
            nbytes = count * abs(bitpix) // 8
            buf = f.read(nbytes + ((-nbytes) % BLOCK))
            arr = np.frombuffer(buf[:nbytes], dtype=dtype).reshape(shape)
            planes[str(hdr.get("EXTNAME", len(planes))).rstrip()] = arr
    names = _var_names(cfg)
    P = np.stack([planes[n].astype(np.float64) for n in names])
    return P, cfg, t


def npz_to_fits(npz_path: str, fits_path: Optional[str] = None) -> str:
    """Converter CLI body (the silo2fits equivalent)."""
    from .snapshot import load_snapshot

    cfg, P, t, _step = load_snapshot(npz_path)
    out = fits_path or (npz_path.rsplit(".npz", 1)[0].rsplit(".snap", 1)[0]
                        + ".fits")
    return write_fits(out, P, cfg, t=t)


if __name__ == "__main__":  # pragma: no cover
    import sys

    print(npz_to_fits(*sys.argv[1:]))
